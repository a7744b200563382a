"""The frame's TAA wrapper (``ops/temporal_cuda.py``, TS) on the CPU: for
CPU tensors it is ``denoise.temporal_ss``, the plain version, bit for bit,
whole image or row band, f16 or f32 history; its input checks refuse what
the kernel cannot take; and every route's frame calls it once a frame.
The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import raytracedggx_tpu_torch.engine.renderer as t_renderer
from raytracedggx_tpu_torch import denoise
from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
from raytracedggx_tpu_torch.ops import temporal_cuda
from raytracedggx_tpu_torch.scene import Scene, default_materials, ground_cube

H, W = 24, 40
# velocity in viewports: at rest, under a pixel, several pixels, and past
# the image's borders (the reprojection clamps)
MOTION = {"still": 0.0, "subpixel": 0.3 / W, "pixels": 4.0 / W,
          "offscreen": 1.5}
# (full_size, row0): the whole image; the first band of a 36-row image
# (starting in its halo), and a band further down
BANDS = {"image": (None, 0), "first_band": ((W, 36), -3),
         "band": ((W, 36), 5)}


def _inputs(seed, motion, hist_dtype):
    rng = np.random.default_rng(seed)
    cur = rng.uniform(0.0, 4.0, (H, W, 4)).astype(np.float32)
    cur[..., 3] = rng.random((H, W)) < 0.7
    vel = rng.uniform(-1.0, 1.0, (H, W, 2)).astype(np.float32) * motion
    hist = rng.uniform(0.0, 4.0, (H, W, 4)).astype(np.float32)
    hist[..., 3] = rng.integers(0, 16, (H, W)) / 15.0
    hist[H // 3, W // 3, 0] = np.nan       # a pixel takes the NaN fallback
    return (torch.as_tensor(cur), torch.as_tensor(hist).to(hist_dtype),
            torch.as_tensor(vel))


@pytest.mark.parametrize("band", list(BANDS))
@pytest.mark.parametrize("hist_dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("motion", list(MOTION))
def test_cpu_wrapper_is_the_plain_version(motion, hist_dtype, band):
    full_size, row0 = BANDS[band]
    cur, hist, vel = _inputs(len(motion) + 7 * len(band), MOTION[motion],
                             hist_dtype)
    n0 = temporal_cuda.temporal_ss.launches
    got = temporal_cuda.temporal_ss(cur, hist, vel, full_size, row0)
    want = denoise.temporal_ss(cur, hist, vel, full_size, row0)
    assert got.dtype == torch.float32 and got.shape == (H, W, 4)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert temporal_cuda.temporal_ss.launches == n0   # no kernel here


def _bad_inputs():
    cur = torch.zeros((H, W, 4))
    hist = torch.zeros((H, W, 4), dtype=torch.float16)
    vel = torch.zeros((H, W, 2))
    return {
        "float64_current": (cur.double(), hist, vel),
        "float16_velocity": (cur, hist, vel.half()),
        "bfloat16_history": (cur, hist.bfloat16(), vel),
        "float64_history": (cur, hist.double(), vel),
        "current_three_channels": (cur[..., :3], hist, vel),
        "current_2d": (cur[0], hist, vel),
        "current_4d": (cur[None], hist, vel),
        "history_three_channels": (cur, hist[..., :3], vel),
        "history_short": (cur, hist[:-1], vel),
        "velocity_one_channel": (cur, hist, vel[..., :1]),
        "velocity_narrow": (cur, hist, vel[:, :-1]),
        "history_on_another_device": (cur, hist.to("meta"), vel),
        "velocity_on_another_device": (cur, hist, vel.to("meta")),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_kernel_checks_refuse_bad_inputs(case):
    """The checks a CUDA call runs before its launch refuse a dtype, shape
    or device the kernel cannot take."""
    with pytest.raises(ValueError):
        temporal_cuda._check(*_bad_inputs()[case])


def test_kernel_checks_pass_the_frames_inputs():
    """What the frame hands over passes: f16 or f32 history, a velocity
    that is a strided view; the checks give (H, W)."""
    cur, hist, vel = _inputs(1, 0.0, torch.float16)
    wide = torch.cat([vel, vel], dim=-1)[..., 1:3]
    assert temporal_cuda._check(cur, hist, wide) == (H, W)
    assert temporal_cuda._check(cur, hist.float(), vel) == (H, W)


@pytest.mark.parametrize("traversal,kernels", [
    ("wide", "auto"), ("wide", "xla"), ("pallas4", "auto"),
    ("pallas", "auto")])
def test_every_route_calls_the_wrapper_once_a_frame(monkeypatch, traversal,
                                                    kernels):
    """The frame's TAA is the TS wrapper on every route, whatever
    ``kernels`` says: one call a frame, on the frame's (H, W, 4) colour."""
    assert t_renderer.temporal_ss is temporal_cuda.temporal_ss
    assert "TS" in t_renderer.launch_counts()
    calls = []

    def spy(current, *args, **kw):
        calls.append(tuple(current.shape))
        return temporal_cuda.temporal_ss(current, *args, **kw)
    monkeypatch.setattr(t_renderer, "temporal_ss", spy)
    r = Renderer(Scene(meshes=[ground_cube(), ground_cube()],
                       materials=default_materials(),
                       pos_scale=np.array([0, 3.0, 0, 1.0], np.float32)),
                 config=RenderConfig(width=32, height=18, traversal=traversal,
                                     kernels=kernels), device="cpu")
    state = r.init_state()
    for _ in range(2):
        state, _, _ = r.step(state, 1 / 30)
    assert calls == [(18, 32, 4)] * 2
