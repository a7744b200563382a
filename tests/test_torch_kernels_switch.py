"""PyTorch port, ``RenderConfig.kernels`` and ``Renderer.set_kernels``: as
in the reference (raytracedggx_tpu/engine/renderer.py:58-62,358-361,
505-520), they pick only the spatial filters' implementation, the 'V'
toggle.  The traversal follows ``traversal`` alone: with kernels="xla"
every wave still goes through its traversal kernel's wrapper (K1, K4 or
K5; on the CPU the wrapper takes the plain version), while the filters
run their plain passes and never call K2 or K3.
"""

import numpy as np
import pytest
import torch

import raytracedggx_tpu_torch.denoise.spatial as t_spatial
import raytracedggx_tpu_torch.engine.renderer as t_renderer
from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
from raytracedggx_tpu_torch.ops import scene_wide, traverse_cuda, wide
from raytracedggx_tpu_torch.scene import Scene, default_materials, ground_cube

W, H = 96, 54
# traversal -> (module, the kernel wrapper its waves call)
WRAPPERS = {"wide": (scene_wide, "trace_tiles_instanced"),
            "pallas": (traverse_cuda, "trace_tiles_flat"),
            "pallas4": (wide, "trace_tiles4")}


def _renderer(traversal="wide", kernels="auto"):
    r = Renderer(Scene(meshes=[ground_cube(), ground_cube()],
                       materials=default_materials(),
                       pos_scale=np.array([0, 3.0, 0, 1.0], np.float32)),
                 config=RenderConfig(width=W, height=H, traversal=traversal,
                                     kernels=kernels), device="cpu")
    for mesh_idx in (0, 1):       # the diffuse wave and filter live
        r.set_metallic(mesh_idx, 0.5)
    return r


def _spy(monkeypatch, module, name, log, tag=None):
    """Replace module.name by a wrapper that logs each call (with its
    impl= keyword when tag is given) and calls the original."""
    fn = getattr(module, name)

    def spy(*args, **kw):
        log.append((tag, kw.get("impl")) if tag else name)
        return fn(*args, **kw)
    monkeypatch.setattr(module, name, spy)


@pytest.fixture
def spies(monkeypatch):
    """Calls of the traversal wrappers, of the filters (with impl) and of
    the K2 / K3 wrappers."""
    log = {"trace": [], "filters": [], "k2k3": []}
    for module, name in WRAPPERS.values():
        _spy(monkeypatch, module, name, log["trace"])
    _spy(monkeypatch, t_renderer, "reflection_spatial_filter",
         log["filters"], "refl")
    _spy(monkeypatch, t_renderer, "diffuse_spatial_filter", log["filters"],
         "diff")
    for name in ("reflection_pass", "diffuse_pass"):
        _spy(monkeypatch, t_spatial, name, log["k2k3"])
    return log


@pytest.mark.parametrize("traversal", ["wide", "pallas", "pallas4"])
def test_xla_kernels_keep_the_traversal_kernel(spies, traversal):
    """kernels="xla": each wave still calls its traversal kernel's wrapper
    (three waves; the per-mesh paths once per instance), the filters get
    impl="xla" and K2 / K3 are never called."""
    r = _renderer(traversal, kernels="xla")
    r.step(r.init_state())
    per_wave = 1 if traversal == "wide" else 2
    assert spies["trace"] == [WRAPPERS[traversal][1]] * 3 * per_wave
    assert spies["filters"] == [("refl", "xla"), ("diff", "xla")]
    assert spies["k2k3"] == []


def test_set_kernels_switches_only_the_filters(spies):
    """set_kernels("xla") after a frame at "auto": the next frame's filters
    run their plain passes, the traversal kernel is still called, and the
    frame and history equal a fresh kernels="xla" renderer's from the same
    state.  Unchanged it is a no-op; bad values raise."""
    r = _renderer()
    state, _, _ = r.step(r.init_state())
    assert spies["filters"] == [("refl", "cuda"), ("diff", "cuda")]
    assert spies["k2k3"] == ["reflection_pass"] * 2 + ["diffuse_pass"] * 2
    del spies["filters"][:], spies["k2k3"][:]
    r.set_kernels("xla")
    got_state, got, _ = r.step(state)
    assert spies["filters"] == [("refl", "xla"), ("diff", "xla")]
    assert spies["k2k3"] == [] and len(spies["trace"]) == 6
    want_state, want, _ = _renderer(kernels="xla").step(state)
    assert torch.equal(got, want)
    assert torch.equal(got_state.history, want_state.history)
    r.set_kernels("xla")
    assert (r.kernels, r.impl, r.config.kernels) == ("xla", "xla", "auto")
    with pytest.raises(ValueError):
        r.set_kernels("pallas")
    with pytest.raises(ValueError, match="CUDA device"):
        r.set_kernels("cuda")
    assert r.impl == "xla"
