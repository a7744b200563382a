"""PyTorch port parity, the renderer's off-by-default knobs.

``trace_slim`` and ``sort_dir_bits=6`` against the port's default frame
on the golden cube scene at 96x54, 3 frames: the 6-bit frame is a pure
reordering of the bounce waves, bit for bit on the CPU; the slim frame is
at the golden bar of tests/test_golden.py:46-48 (max 0.02, mean 0.002).
``trace_slim`` acts on "wide" only and is refused elsewhere, and the
knobs keep the JAX package's names and defaults.  Its anchor sort key
and its profiling ablations are not ported: ``RenderConfig`` has every
field of the JAX package's but those and the TPU bucket prefix's."""

import dataclasses

import numpy as np
import pytest

from raytracedggx_tpu.engine import RenderConfig as JRenderConfig

from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
from raytracedggx_tpu_torch.scene import Scene, default_materials, ground_cube

W, H, FRAMES = 96, 54, 3
POS = np.array([0, 3.0, 0, 1.0], np.float32)


def _golden_bar(got, want):
    """tests/test_golden.py:46-48."""
    diff = np.abs(np.clip(got, 0, 1) - np.clip(want, 0, 1))
    assert float(diff.max()) < 0.02, f"max pixel diff {diff.max():.4f}"
    assert float(diff.mean()) < 0.002, f"mean diff {diff.mean():.5f}"


def _renderer(**knobs):
    return Renderer(Scene(meshes=[ground_cube(), ground_cube()],
                          materials=default_materials(), pos_scale=POS),
                    config=RenderConfig(width=W, height=H, **knobs),
                    device="cpu")


def _port(**knobs):
    return _renderer(**knobs).run_frames(FRAMES)[1].numpy()


# the JAX package's fields the port does not have
NOT_PORTED = ("sort_anchor", "dbg_no_refl_trace", "dbg_no_secondary_shade",
              "dbg_env_mode", "dbg_miss_lod",
              "secondary_bucket")     # the static bucket prefix (raygen)


def test_slim_and_dir_bits_frames_match_the_default_frame():
    base = _port()
    np.testing.assert_array_equal(_port(sort_dir_bits=6), base)
    _golden_bar(_port(trace_slim=True), base)


def test_knob_defaults_are_the_references():
    names = ("sort_dir_bits", "trace_slim")
    ours = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JRenderConfig)}
    assert {n: ours[n] for n in names} == {n: ref[n] for n in names}


def test_config_fields_are_the_references_less_the_unported():
    ours = [f.name for f in dataclasses.fields(RenderConfig)]
    ref = [f.name for f in dataclasses.fields(JRenderConfig)]
    assert ours == [n for n in ref if n not in NOT_PORTED]
    assert set(NOT_PORTED) <= set(ref)


@pytest.mark.parametrize("traversal", ["pallas4", "pallas", "jax"])
def test_wide_only_knobs_are_refused_elsewhere(traversal):
    scene = Scene(meshes=[ground_cube(), ground_cube()],
                  materials=default_materials(), pos_scale=POS)
    with pytest.raises(ValueError):
        Renderer(scene, config=RenderConfig(width=W, height=H,
                                            traversal=traversal,
                                            trace_slim=True), device="cpu")
    with pytest.raises(ValueError):
        Renderer(scene, config=RenderConfig(width=W, height=H,
                                            sort_dir_bits=4), device="cpu")


def test_sort_dir_bits_reach_the_bounce_sort(monkeypatch):
    """The renderer hands each bounce wave's sort its sort_dir_bits."""
    import raytracedggx_tpu_torch.trace.raygen as raygen

    seen = []
    sort = raygen.sort_rays_morton

    def spy(*a, **kw):
        seen.append(kw["dir_bits"])
        return sort(*a, **kw)

    monkeypatch.setattr(raygen, "sort_rays_morton", spy)
    scene = Scene(meshes=[ground_cube(), ground_cube()],
                  materials=default_materials(), pos_scale=POS)
    for knobs, bits in ((dict(), 3), (dict(sort_dir_bits=6), 6)):
        seen.clear()
        r = Renderer(scene, config=RenderConfig(width=W, height=H, **knobs),
                     device="cpu")
        r.step(r.init_state())
        assert seen == [bits]                        # the reflection wave
