"""PyTorch port parity, whole frames through the per-mesh traversals
(``traversal="pallas4"``, ``"pallas"`` and ``"jax"``: the reference's
``trace_fn`` route with vertex-fetch shading) and ``bary_mode="ndc"`` with
``emulate_formats``.

On the CPU the K4 and K5 wrappers take their plain version, so these
frames check everything around the traversal kernels: the per-instance
loop, the vertex fetch, the NDC barycentrics, the unsorted and sorted
secondary waves and the storage-format round trips.  The JAX side is the
reference's own ``traversal="jax"`` renderer, the route by which both cube
goldens were made.  Bars: tests/test_golden.py:92-99 between renderers,
:174-176 against the ndc+formats golden."""

import os

import numpy as np
import pytest
import torch

from raytracedggx_tpu.engine import RenderConfig as JRenderConfig
from raytracedggx_tpu.engine import Renderer as JRenderer
from raytracedggx_tpu.scene import Scene as JScene
from raytracedggx_tpu.scene import default_materials as j_materials
from raytracedggx_tpu.scene.mesh import ground_cube as j_ground_cube

from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
from raytracedggx_tpu_torch.scene import Scene, default_materials, ground_cube

W, H, FRAMES, METAL_FRAMES = 96, 54, 3, 2
POS = np.array([0, 3.0, 0, 1.0], np.float32)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "cube_scene_96x54_f3.png")
NDC_FMT_GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                              "cube_scene_96x54_ndc_fmt_f3.png")


def _scene():
    return Scene(meshes=[ground_cube(), ground_cube()],
                 materials=default_materials(), pos_scale=POS)


def _frames(renderer, step):
    """Frames after 3 all-metal steps and after 2 more at metallic 0.5
    (the diffuse wave live)."""
    state, out = renderer.init_state(), []
    for frames, metallic in ((FRAMES, None), (METAL_FRAMES, 0.5)):
        if metallic is not None:
            renderer.set_metallic(0, metallic)
            renderer.set_metallic(1, metallic)
        for _ in range(frames):
            state, frame = step(renderer, state)
        out.append(np.asarray(frame))
    return out


@pytest.fixture(scope="module")
def reference_frames():
    jr = JRenderer(JScene(meshes=[j_ground_cube(), j_ground_cube()],
                          materials=j_materials(), pos_scale=POS),
                   config=JRenderConfig(width=W, height=H, traversal="jax"))
    return _frames(jr, lambda r, s: r.step(s, 1 / 60)[:2])


def _frame_bar(got, want):
    """tests/test_golden.py:92-99."""
    diff = np.abs(np.clip(got, 0, 1) - np.clip(want, 0, 1))
    assert float(diff.mean()) < 1e-3, f"mean diff {diff.mean()}"
    assert float(diff.max()) < 0.15, f"max diff {diff.max()}"
    frac_big = float((diff.max(axis=-1) > 0.05).mean())
    assert frac_big < 2e-3, f"{frac_big:.2%} pixels differ > 0.05"


@pytest.mark.parametrize("traversal", ["pallas4", "pallas", "jax"])
def test_per_mesh_paths_match_reference_renderer(reference_frames,
                                                 traversal):
    r = Renderer(_scene(), config=RenderConfig(width=W, height=H,
                                               traversal=traversal),
                 device="cpu")
    got = _frames(r, lambda r, s: r.step(s, 1 / 60)[:2])
    for g, want in zip(got, reference_frames):
        _frame_bar(g, want)


@pytest.mark.parametrize("traversal", ["pallas4", "pallas", "jax", "wide"])
def test_ndc_formats_golden(traversal):
    """tests/test_golden.py:167-176 through every traversal ("wide"
    reaches the vertices through its trace_fn wrapper)."""
    from PIL import Image

    r = Renderer(_scene(), config=RenderConfig(
        width=W, height=H, traversal=traversal, bary_mode="ndc",
        emulate_formats=True), device="cpu")
    state, frame = r.run_frames(FRAMES)
    want = np.asarray(Image.open(NDC_FMT_GOLDEN), np.float32) / 255.0
    diff = np.abs(np.clip(frame.numpy(), 0, 1) - want[..., :3])
    assert float(diff.mean()) < 2e-3, f"mean diff {diff.mean()}"
    assert float((diff.max(-1) > 0.05).mean()) < 2e-3, "pixels drifted"
    assert state.history.dtype == torch.float16


@pytest.mark.parametrize("traversal", ["pallas4", "pallas"])
def test_default_golden(traversal):
    """The default frame's golden (tests/test_torch_renderer.py's bar)
    through the per-mesh traversals, as chip_smoke.py checks it on the
    card."""
    from PIL import Image

    r = Renderer(_scene(), config=RenderConfig(width=W, height=H,
                                               traversal=traversal),
                 device="cpu")
    state, frame = r.run_frames(FRAMES)
    want = np.asarray(Image.open(GOLDEN), np.float32) / 255.0
    diff = np.abs(np.clip(frame.numpy(), 0, 1) - want[..., :3])
    assert float(diff.mean()) < 3e-3, f"mean diff {diff.mean()}"
    assert float((diff.max(-1) > 0.05).mean()) < 2e-3, "pixels drifted"
    assert state.history.dtype == torch.float16


def test_renderer_needs_cuda_unless_told_cpu(monkeypatch):
    """The entry point defaults to the card and never falls back to the
    CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = RenderConfig(width=16, height=8, traversal="pallas4")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Renderer(_scene(), config=config)
    r = Renderer(_scene(), config=config, device="cpu")
    assert r.device.type == "cpu" and r.geom.wide and not r.geom.flat
    with pytest.raises(ValueError):
        Renderer(_scene(), config=RenderConfig(traversal="bogus"),
                 device="cpu")
