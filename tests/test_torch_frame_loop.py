"""The port's frame loop on the CPU: frames whose constants come from
the packed row of frame constants (``frame_index`` a tensor), whose gates
are decided on the host and which read nothing back, against the JAX
package's ``Renderer.step`` (and its ``cam`` override) at 48x32 on the
golden cube scene; the gates' identity; ``step_n``, ``run_frames`` and
``async_compute`` against a ``step`` loop, bit for bit.

The JAX renderer is set up as in tests/test_torch_renderer.py (its
Pallas traversal swapped for the brute-force JAX twin) and held to that
file's frame bar.  ``step_n``'s captured path is rehearsed here with the
CUDA stream and graph calls running the frame eagerly (``_rehearse``);
the capture itself is held to the ``step`` loop bit for bit on the card
(tests/test_torch_cuda.py).
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import raytracedggx_tpu.ops.scene_wide as j_scene_wide
import raytracedggx_tpu_torch.trace.raygen as t_raygen
from raytracedggx_tpu.engine import RenderConfig as JRenderConfig
from raytracedggx_tpu.engine import Renderer as JRenderer
from raytracedggx_tpu.scene import Scene as JScene
from raytracedggx_tpu.scene import default_materials as j_materials
from raytracedggx_tpu.scene.camera import OrbitController as JOrbit
from raytracedggx_tpu.scene.mesh import ground_cube as j_ground_cube

from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
from raytracedggx_tpu_torch.engine import renderer as t_renderer
from raytracedggx_tpu_torch.scene import Scene, default_materials, ground_cube
from raytracedggx_tpu_torch.scene.camera import OrbitController
from test_torch_raygen import jax_bruteforce_fused
from test_torch_renderer import POS, _frame_bar

W, H = 48, 32
DRAG, WHEEL = (64.0, -32.0), 1.0
# the model instance behind the camera: no primary ray reaches it
BEHIND = np.array([22.0, 19.0, -54.0, 1.0], np.float32)


def _scene(pos=POS):
    return Scene(meshes=[ground_cube(), ground_cube()],
                 materials=default_materials(), pos_scale=pos)


def _renderer(pos=POS, **cfg):
    return Renderer(_scene(pos), config=RenderConfig(width=W, height=H,
                                                     **cfg), device="cpu")


@pytest.fixture(scope="module")
def reference():
    """The JAX renderer's frames: one frame with the orbit camera after a
    drag and a wheel notch; then, from a new state, 2 all-metal frames
    and 2 at metallic 0.5.  Every frame takes the ``cam`` path (the
    construction camera's own arrays for the plain frames), so the frame
    is compiled once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_scene_wide, "trace_scene_wide_fused",
                   jax_bruteforce_fused)
        jr = JRenderer(JScene(meshes=[j_ground_cube(), j_ground_cube()],
                              materials=j_materials(), pos_scale=POS),
                       config=JRenderConfig(width=W, height=H,
                                            traversal="wide"))
        orbit = JOrbit(jr.camera)
        orbit.drag(*DRAG)
        orbit.wheel(WHEEL)
        cam = orbit.arrays()
        _, cam_frame, _ = jr.step(jr.init_state(), 1 / 60, cam=cam)
        own = (jr.view_proj, jr.proj_to_world, jr.eye)
        js, frames = jr.init_state(), []
        for metallic in (None, None, 0.5, None):
            if metallic is not None:
                jr.set_metallic(0, metallic)
                jr.set_metallic(1, metallic)
            js, jf, _ = jr.step(js, 1 / 60, cam=own)
            frames.append(np.asarray(jf))
    return dict(cam=[np.asarray(x) for x in cam],
                cam_frame=np.asarray(cam_frame), frames=frames)


def test_syncless_frames_match_reference(reference):
    """The frame reads its constants from the packed row (frame_index a
    0-dim int64 tensor) and decides its gates on the host: all-metal
    frames, then frames at metallic 0.5 (diffuse wave and filter live)."""
    r = _renderer()
    state = r.init_state()
    seen = []
    unpack = r._layout.unpack

    def spy(row):
        consts, inv_mats = unpack(row)
        seen.append(consts.frame_index)
        return consts, inv_mats

    r._layout.unpack = spy
    for i, want in enumerate(reference["frames"]):
        if i == 2:
            r.set_metallic(0, 0.5)
            r.set_metallic(1, 0.5)
        state, frame, _ = r.step(state, 1 / 60)
        assert r._gates() == ((True, True) if i >= 2 else (False, False))
        _frame_bar(frame.numpy(), want)
    assert [int(f) for f in seen] == [0, 1, 2, 3]
    assert all(f.dtype == torch.int64 and f.dim() == 0 for f in seen)


def test_cam_override_matches_reference(reference):
    """OrbitController.arrays() after the same drag and wheel notch as
    the reference's, through step(cam=...), against the reference's
    frame; the construction camera is unchanged afterwards."""
    r = _renderer()
    orbit = OrbitController(r.camera)
    orbit.drag(*DRAG)
    orbit.wheel(WHEEL)
    cam = orbit.arrays()
    for got, want in zip(cam, reference["cam"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    _, frame, _ = r.step(r.init_state(), 1 / 60, cam=cam)
    _frame_bar(frame.numpy(), reference["cam_frame"])
    _, plain, _ = r.step(r.init_state(), 1 / 60)
    assert not torch.equal(plain, frame)


class _Syncs(TorchDispatchMode):
    """Records the operations that read a tensor back to the host or
    make one from host data (on a CUDA device: a wait on the stream or a
    copy from pageable memory, which a captured frame cannot hold)."""

    OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh",
           "aten.masked_select", "aten.unique", "aten._unique")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.OPS):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("cfg", [
    dict(traversal="wide"),
    dict(traversal="wide", trace_slim=True, sort_dir_bits=6,
         emulate_formats=True, kernels="xla"),
    dict(traversal="pallas4", bary_mode="ndc"),
    dict(traversal="pallas"),
])
def test_frame_reads_nothing_back(monkeypatch, cfg):
    """After a first frame (which builds the per-device constants), the
    device work of a frame, its refit and its render, makes no host read
    and no tensor from host data, with the diffuse wave and filter live."""
    r = _renderer(**cfg)
    r.set_metallic(0, 0.5)
    state, _, _ = r.step(r.init_state())
    seen = []
    for name in ("_refit", "_render"):
        fn = getattr(Renderer, name)

        def checked(self, *args, _fn=fn):
            with _Syncs() as mode:
                out = _fn(self, *args)
            seen.extend(mode.seen)
            return out

        monkeypatch.setattr(Renderer, name, checked)
    r.step(state)
    assert seen == []


def _spy_gated(monkeypatch):
    calls = {"wave": 0, "filter": 0}

    def counted(key, fn):
        def run(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(t_raygen, "cos_dir",
                        counted("wave", t_raygen.cos_dir))
    monkeypatch.setattr(t_renderer, "diffuse_spatial_filter",
                        counted("filter", t_renderer.diffuse_spatial_filter))
    return calls


def test_open_gates_are_an_identity_where_no_pixel_passes(monkeypatch):
    """The model at metallic 0.99 behind the camera: the host opens both
    gates, no hit pixel passes them, and the frames equal the frames
    with both gates shut bit for bit."""
    calls = _spy_gated(monkeypatch)
    frames = {}
    for gates in ("open", "shut"):
        r = _renderer(BEHIND)
        r.set_metallic(1, 0.99)
        if gates == "shut":
            monkeypatch.setattr(r, "_gates", lambda: (False, False))
        else:
            assert r._gates() == (True, True)
        state, frames[gates] = r.init_state(), []
        for _ in range(3):
            state, frame, aux = r.step(state, 1 / 60)
            frames[gates].append((frame, state.history))
        inst = (aux["vis"] - 1) >> 24
        hit = aux["normal"][..., 3] > 0.5
        assert int(hit.sum()) > 0 and not bool((hit & (inst == 1)).any())
        if gates == "open":
            assert calls == {"wave": 3, "filter": 3}
    assert calls == {"wave": 3, "filter": 3}
    for (f_open, h_open), (f_shut, h_shut) in zip(frames["open"],
                                                  frames["shut"]):
        assert torch.equal(f_open, f_shut) and torch.equal(h_open, h_shut)


@pytest.mark.parametrize("metallic,gates", [(0.999, (True, False)),
                                            (0.99, (True, True))])
def test_filter_gate_reads_the_stored_metallic(metallic, gates):
    """With emulate_formats the G-buffer stores metallic in 8 bits: 0.999
    stores as 1, so the host shuts the filter's gate while the wave's
    (unquantized) stays open, as the stored G-buffer says per pixel."""
    r = _renderer(emulate_formats=True)
    for mesh in (0, 1):
        r.set_metallic(mesh, metallic)
    assert r._gates() == gates
    _, _, aux = r.step(r.init_state())
    hit = aux["normal"][..., 3] > 0.5
    stored = torch.round(aux["rough_metal"][..., 1] * 255.0) / 255.0
    assert bool((hit & (stored < 1.0)).any()) == gates[1]
    assert bool((hit & (aux["rough_metal"][..., 1] < 1.0)).any()) == gates[0]


class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    """A CUDAGraph stand-in: a replay runs the renderer's captured frame
    into the frame tensor the capture returned."""

    renderer = None

    def replay(self):
        r = _Graph.renderer
        r._graph[2].copy_(r._captured_frame())


def _rehearse(monkeypatch, r):
    """step_n's captured path on the CPU: ``captures`` holds, the stream
    and graph calls run the frame eagerly; returns the list of capture
    keys."""
    keys = []
    capture = Renderer._capture

    def counted(self, key, row0, history):
        keys.append(key)
        return capture(self, key, row0, history)

    monkeypatch.setattr(Renderer, "captures", property(lambda self: True))
    monkeypatch.setattr(Renderer, "_capture", counted)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    _Graph.renderer = r
    return keys


def _same(a, b):
    (sa, fa), (sb, fb) = a, b
    assert torch.equal(fa, fb) and torch.equal(sa.history, sb.history)
    assert torch.equal(sa.prev_wvp, sb.prev_wvp)
    assert sa.angle == sb.angle and sa.frame == sb.frame


@pytest.mark.parametrize("captured", [False, True])
def test_step_n_equals_step_loop(monkeypatch, captured):
    """step_n(4) and four steps give the same frame and state bit for
    bit (tests/test_cli.py:72-87); rehearsed through the capture, and
    across set_* calls between chunks: a set_metallic that opens the
    gates and set_kernels capture again, one that leaves them open
    updates the materials in place."""
    loop, chunk = _renderer(), _renderer()
    keys = _rehearse(monkeypatch, chunk) if captured else []
    assert chunk.captures == captured
    s_loop, s_chunk = loop.init_state(), chunk.init_state()
    for n, change in ((4, None), (2, ("set_metallic", 1, 0.5)),
                      (2, ("set_metallic", 1, 0.25)),
                      (1, ("set_kernels", "xla"))):
        if change is not None:
            for r in (loop, chunk):
                getattr(r, change[0])(*change[1:])
        frame = None
        for _ in range(n):
            s_loop, frame, _ = loop.step(s_loop, 1 / 30)
        s_chunk, f_chunk = chunk.step_n(s_chunk, n, 1 / 30)
        _same((s_loop, frame), (s_chunk, f_chunk))
    assert s_chunk.frame == 9
    if captured:
        assert len(keys) == 3 and chunk.capture_launches is not None
        assert [k[1] for k in keys] == [(False, False), (True, True),
                                        (True, True)]
        assert [k[0] for k in keys] == ["auto", "auto", "xla"]


def test_step_n_needs_a_frame():
    r = _renderer()
    with pytest.raises(ValueError, match="num_frames"):
        r.step_n(r.init_state(), 0)


def test_run_frames_equals_step_loop():
    """run_frames (frames_in_flight bounded) gives the step loop's last
    frame and state (tests/test_cli.py:72-87)."""
    r = _renderer()
    fast = r.run_frames(4, dt=1 / 30, frames_in_flight=2)
    state = r.init_state()
    for _ in range(4):
        state, slow, _ = r.step(state, 1 / 30)
    _same(fast, (state, slow))


def test_async_toggle_identical_frames():
    """async_compute on and off render the same frames
    (tests/test_cli.py:51-69); set_async_compute flips it."""
    frames = {}
    for on in (True, False):
        r = _renderer(async_compute=on)
        state = r.init_state()
        for _ in range(2):
            state, frames[on], _ = r.step(state, 1 / 30)
        r.set_async_compute(not on)
        assert r.config.async_compute == (not on)
    assert torch.equal(frames[True], frames[False])
