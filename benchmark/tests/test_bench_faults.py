"""The comparison rejects what it must, at a size a test run holds: the
control (the reference with TF32 matrix products in the program's place)
and a run whose timed path is broken underneath, once for each fault a
cell of one chip can have.  The device check is skipped; the rest of a
run is driven as ``run.py`` drives it, on the CPU."""

import dataclasses

import pytest
import torch

import calibrate
import judge
import run
import spec
from conftest import with_extra
from harness import Draw, set_up
from raytracedggx_tpu_torch.engine import Renderer

CPU = torch.device("cpu")
SEEDS = (11, 2 ** 31 + 3, 987654321)
# tile_mae's limit for the bunny cut to 64x36 with conftest.EXTRA, from
# CPU readings at that size (the worst kept frame of a 0.2 s window):
# sound runs 1.2e-3 to 1.5e-2 at seeds 5, 11, 42, 77, 3141592653 and
# SEEDS; the control 0.18 to 0.42; one extra instance moved by its radius
# 0.10 (seed 11) and 0.15 (seed 5).  At this size one grazing pixel whose
# reflection ray dies on one route and not on the other, spread by the
# spatial filter, reads as much as a fault (seed 123456: 0.12, and
# frame_mae 1.15e-3 with or without the extra instances), so the limit
# holds at these tests' seeds; PERF.md gives the readings at 3840x2160
TILE_LIMIT = 4e-2


def _cell(tiny_cell, name):
    """The named cell at a test's size; ``+extra3`` after the name: with
    conftest.EXTRA's three extra instances and a tile_mae limit."""
    name, extra = name.split("+")[0], name.endswith("+extra3")
    cell = tiny_cell(name)
    if extra:
        with_extra(cell.config)
        cell.limits = dict(cell.limits, tile_mae=TILE_LIMIT)
    return cell


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


class OneInstanceMoved(Renderer):
    """One extra instance drawn wrong: every frame's constants put the last
    one its own radius (0.6) further along x than the scene, which the
    set-up checks, has it."""

    def _fill(self, row, frame, angle, cam):
        scene = self.scene
        *rest, (x, y, z, s) = scene.extra_instances
        self.scene = dataclasses.replace(
            scene, extra_instances=(*rest, (x + s, y, z, s)))
        try:
            return super()._fill(row, frame, angle, cam)
        finally:
            self.scene = scene


class BuiltElsewhere(Renderer):
    """Extra instances built somewhere other than the configuration says:
    each 0.5 further along z."""

    def __init__(self, scene, **kwargs):
        moved = tuple((x, y, z + 0.5, s)
                      for x, y, z, s in scene.extra_instances)
        super().__init__(dataclasses.replace(scene, extra_instances=moved),
                         **kwargs)


CELLS = ["bunny-720p.anim-m1", "dragon-720p.anim-m05",
         "bunny-720p.anim-m1+extra3"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_pass_and_the_control_fails(tiny_cell, name):
    cell = _cell(tiny_cell, name)
    for seed in SEEDS:
        prog, ctrl = calibrate.readings(cell, seed, 0.2, CPU, control=True)
        assert judge.verdict(prog, cell.limits), prog
        assert not judge.verdict(ctrl, cell.limits), ctrl


@pytest.mark.parametrize("fault", [Unchanged, HalfRows, Altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_cell, name, fault):
    cell = _cell(tiny_cell, name)
    out = run.run(cell, SEEDS[0], 0.2, False, CPU, renderer_cls=fault,
                  log=lambda s: None)
    assert out["correct"] is False
    assert out["failed"] >= 1


def test_one_extra_instance_drawn_wrong_is_not_correct(tiny_cell):
    """The whole frame's mean dilutes the fault (at 3840x2160 on the H100
    frame_mae read 2.14e-4, under the bunny's 1.2e-3); tile_mae reads it
    whole."""
    cell = _cell(tiny_cell, "bunny-720p.anim-m1+extra3")
    out = run.run(cell, SEEDS[0], 0.2, False, CPU,
                  renderer_cls=OneInstanceMoved, log=lambda s: None)
    assert out["correct"] is False
    assert out["checks"]["tile_mae"]["value"] > TILE_LIMIT


def test_extra_instances_built_elsewhere_are_refused(tiny_cell):
    cell = _cell(tiny_cell, "bunny-720p.anim-m1+extra3")
    with pytest.raises(spec.Refused, match="extra_instances"):
        set_up(cell.config, cell.traffic, Draw.of(SEEDS[0]), CPU, 0.0,
               renderer_cls=BuiltElsewhere)
