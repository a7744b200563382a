"""The comparison rejects what it must, at a size a test run holds: the
control (the reference with TF32 matrix products in the program's place)
and a run whose timed path is broken underneath, once for each fault a
cell of one chip can have.  The device check is skipped; the rest of a
run is driven as ``run.py`` drives it, on the CPU."""

import pytest
import torch

import calibrate
import judge
import run
from raytracedggx_tpu_torch.engine import Renderer

CPU = torch.device("cpu")
SEEDS = (11, 2 ** 31 + 3, 987654321)


class Unchanged(Renderer):
    """A step that returns its state unchanged."""

    def step_n(self, state, num_frames, dt=1 / 60):
        _, frame = super().step_n(state, num_frames, dt)
        return state, frame


class HalfRows(Renderer):
    """Half of the batch left out: the lower half of the rows is never
    rendered, its history left as it was and its pixels black."""

    def step_n(self, state, num_frames, dt=1 / 60):
        new, frame = super().step_n(state, num_frames, dt)
        h = frame.shape[0] // 2
        frame, hist = frame.clone(), new.history.clone()
        frame[h:] = 0.0
        hist[h:] = state.history[h:]
        return new._replace(history=hist), frame


class Altered(Renderer):
    """An answer altered where it is produced: each frame 2% brighter."""

    def step_n(self, state, num_frames, dt=1 / 60):
        new, frame = super().step_n(state, num_frames, dt)
        return new, frame * 1.02


@pytest.mark.parametrize("name", ["bunny-720p.anim-m1",
                                  "dragon-720p.anim-m05"])
def test_sound_runs_pass_and_the_control_fails(tiny_cell, name):
    cell = tiny_cell(name)
    for seed in SEEDS:
        prog, ctrl = calibrate.readings(cell, seed, 0.2, CPU, control=True)
        assert judge.verdict(prog, cell.limits), prog
        assert not judge.verdict(ctrl, cell.limits), ctrl


@pytest.mark.parametrize("fault", [Unchanged, HalfRows, Altered])
@pytest.mark.parametrize("name", ["bunny-720p.anim-m1",
                                  "dragon-720p.anim-m05"])
def test_a_broken_timed_path_is_not_correct(tiny_cell, name, fault):
    cell = tiny_cell(name)
    out = run.run(cell, SEEDS[0], 0.2, False, CPU, renderer_cls=fault,
                  log=lambda s: None)
    assert out["correct"] is False
    assert out["failed"] >= 1
