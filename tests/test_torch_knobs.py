"""PyTorch port parity, the renderer's off-by-default knobs.

Each ``dbg_*`` ablation on the golden cube scene at 96x54: the port's
``Renderer`` against the JAX package's ``Renderer(traversal="wide")`` with
the same knob, its Pallas traversal swapped for the brute-force JAX twin
(test_torch_raygen.jax_bruteforce_fused, as test_torch_renderer.py does),
3 frames, at the golden bar of tests/test_golden.py:46-48 (max 0.02, mean
0.002) away from the pixels where the two reflection waves disagree on a
hit.  Those are coin flips of float32 order: a reflection ray leaves its
surface point, which each side computes in its own order, and re-hits
its start triangle near t_min, or grazes a cube's edge, on one side only.
The default frame absorbs them (up to 0.054 on a few pixels,
test_torch_renderer.py), but ``dbg_no_secondary_shade`` and
``dbg_env_mode="no_env"`` turn such a hit into 0 or a grey against the
env's 1-3 on the other side.  The test finds them before the filters (the
pixels where the two sides' reflection radiance differs by more than
1e-3), counts them (a few in 5,184), and leaves out their neighbourhood
in the frames: 16 pixels each way, the spatial filters' reach, and one
more for TAA's motion.

``trace_slim`` and ``sort_anchor`` with ``sort_dir_bits=6`` against the
port's default frame: the anchor frame is a pure reordering, bit for bit
on the CPU; the slim frame at the golden bar.  Both knobs act on "wide"
only and are refused elsewhere."""

import dataclasses

import numpy as np
import pytest

import raytracedggx_tpu.ops.scene_wide as j_scene_wide
from raytracedggx_tpu.engine import RenderConfig as JRenderConfig
from raytracedggx_tpu.engine import Renderer as JRenderer
from raytracedggx_tpu.scene import Scene as JScene
from raytracedggx_tpu.scene import default_materials as j_materials
from raytracedggx_tpu.scene.mesh import ground_cube as j_ground_cube

from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
from raytracedggx_tpu_torch.scene import Scene, default_materials, ground_cube
from test_torch_raygen import jax_bruteforce_fused

W, H, FRAMES = 96, 54, 3
POS = np.array([0, 3.0, 0, 1.0], np.float32)


def _golden_bar(got, want, keep=None):
    """tests/test_golden.py:46-48 on the pixels ``keep`` (all if None)."""
    diff = np.abs(np.clip(got, 0, 1) - np.clip(want, 0, 1))
    if keep is not None:
        diff = diff[keep]
    assert float(diff.max()) < 0.02, f"max pixel diff {diff.max():.4f}"
    assert float(diff.mean()) < 0.002, f"mean diff {diff.mean():.5f}"


def _renderer(**knobs):
    return Renderer(Scene(meshes=[ground_cube(), ground_cube()],
                          materials=default_materials(), pos_scale=POS),
                    config=RenderConfig(width=W, height=H, **knobs),
                    device="cpu")


def _port(**knobs):
    return _renderer(**knobs).run_frames(FRAMES)[1].numpy()


def _reach(flips, r=17):
    """Pixels within r of a flip along both axes (a box)."""
    near = np.zeros_like(flips)
    for y, x in np.argwhere(flips):
        near[max(0, y - r):y + r + 1, max(0, x - r):x + r + 1] = True
    return near


KNOBS = [dict(dbg_no_refl_trace=True), dict(dbg_no_secondary_shade=True),
         dict(dbg_env_mode="no_env"), dict(dbg_env_mode="bilinear"),
         dict(dbg_miss_lod=1.5)]


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(
    f"{a}={b}" for a, b in k.items()))
def test_dbg_knob_frames_match_reference(monkeypatch, knobs):
    monkeypatch.setattr(j_scene_wide, "trace_scene_wide_fused",
                        jax_bruteforce_fused)
    jr = JRenderer(JScene(meshes=[j_ground_cube(), j_ground_cube()],
                          materials=j_materials(), pos_scale=POS),
                   config=JRenderConfig(width=W, height=H, traversal="wide",
                                        **knobs))
    tr = _renderer(**knobs)
    js, ts = jr.init_state(), tr.init_state()
    flips = np.zeros((H, W), bool)
    for _ in range(FRAMES):
        js, jf, ja = jr.step(js, 1 / 60)
        ts, tf, ta = tr.step(ts, 1 / 60)
        flips |= np.abs(np.asarray(ja["refl"]) - ta["refl"].numpy()
                        ).max(axis=-1) > 1e-3
    keep = ~_reach(flips)
    print(f"{knobs}: {int(flips.sum())} reflection coin flips, "
          f"{keep.mean():.3f} of the frame compared")
    assert flips.sum() <= 0.005 * flips.size and keep.mean() > 0.4
    got = tf.numpy()
    _golden_bar(got, np.asarray(jf), keep)
    # the knob changes the frame: it is not ignored
    assert np.abs(got - _port()).max() > 1e-4


def test_slim_and_anchor_frames_match_the_default_frame():
    base = _port()
    anchor = _port(sort_anchor=8, sort_dir_bits=6)
    np.testing.assert_array_equal(anchor, base)
    _golden_bar(_port(trace_slim=True), base)


def test_knob_defaults_are_the_references():
    names = ("sort_dir_bits", "sort_anchor", "trace_slim",
             "dbg_no_refl_trace", "dbg_no_secondary_shade", "dbg_env_mode",
             "dbg_miss_lod")
    ours = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JRenderConfig)}
    assert {n: ours[n] for n in names} == {n: ref[n] for n in names}


@pytest.mark.parametrize("traversal", ["pallas4", "pallas", "jax"])
def test_wide_only_knobs_are_refused_elsewhere(traversal):
    scene = Scene(meshes=[ground_cube(), ground_cube()],
                  materials=default_materials(), pos_scale=POS)
    for knobs in (dict(trace_slim=True), dict(sort_anchor=8)):
        with pytest.raises(ValueError):
            Renderer(scene, config=RenderConfig(width=W, height=H,
                                                traversal=traversal,
                                                **knobs), device="cpu")
    with pytest.raises(ValueError):
        Renderer(scene, config=RenderConfig(width=W, height=H,
                                            sort_dir_bits=4), device="cpu")
    r = Renderer(scene, config=RenderConfig(width=W, height=H,
                                            traversal=traversal,
                                            dbg_env_mode="nope"),
                 device="cpu")
    with pytest.raises(ValueError):
        r.step(r.init_state())


def test_anchor_ids_reach_the_bounce_sort(monkeypatch):
    """With sort_anchor the renderer hands each bounce wave its anchor ids
    and bits; without it, none."""
    import raytracedggx_tpu_torch.trace.raygen as raygen
    from raytracedggx_tpu_torch.ops.scene_wide import anchor_bits

    seen = []
    sort = raygen.sort_rays_morton

    def spy(*a, **kw):
        seen.append((kw["dir_bits"], kw["anchor"], kw["anchor_bits"]))
        return sort(*a, **kw)

    monkeypatch.setattr(raygen, "sort_rays_morton", spy)
    scene = Scene(meshes=[ground_cube(), ground_cube()],
                  materials=default_materials(), pos_scale=POS)
    for knobs, bits in ((dict(), 0), (dict(sort_anchor=8, sort_dir_bits=6),
                                      None)):
        seen.clear()
        r = Renderer(scene, config=RenderConfig(width=W, height=H, **knobs),
                     device="cpu")
        r.step(r.init_state())
        assert len(seen) == 1                        # the reflection wave
        dir_bits, aid, ab = seen[0]
        if bits == 0:
            assert (dir_bits, aid, ab) == (3, None, 0)
        else:
            assert dir_bits == 6 and ab == anchor_bits(r.swide) >= 1
            assert aid.shape == (W * H,)
            assert bool((aid > 0).any()) and int(aid.max()) < 1 << ab
