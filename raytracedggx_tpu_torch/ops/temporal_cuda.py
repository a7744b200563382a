"""The frame's temporal accumulation (TAA): kernel TS and its plain
version.

``temporal_ss(current, history, velocity, full_size=None, row0=0)`` is
``denoise.temporal.temporal_ss``: velocity dilation, the bilinear-clamp
history resample, the YCoCg variance box with its adaptive gamma, the
anti-alias blend and the convergence count in alpha, returning the new
(H, W, 4) float32 accumulation.  The plain version, that module's
whole-image torch operations, is what runs for CPU tensors, so CPU frames
keep their bits.  For CUDA tensors the wrapper launches the CUDA kernel
(``csrc/temporal.cu``), which computes all of it one pixel a thread,
bit for bit the plain version on the card, or raises.  It ports no Pallas
kernel: the JAX package leaves the TAA to XLA.

A row band of a larger image passes the image's ``full_size`` (W, H) and
its first image row ``row0``, as to the plain version.  The history is
float16 (the frame's) or float32; the colour and velocity float32; any
strides.
"""

from __future__ import annotations

import torch

from ..denoise.temporal import temporal_ss as temporal_ss_plain
from .cuda_lib import check_launch, load_library, stream_handle


def _check(current, history, velocity):
    """Raise unless the inputs are what the kernel takes on one device;
    returns (H, W)."""
    dev = current.device
    if history.device != dev or velocity.device != dev:
        raise ValueError(f"temporal_ss: current on {dev}, history on "
                         f"{history.device}, velocity on {velocity.device}: "
                         f"need one device")
    if current.dtype != torch.float32 or velocity.dtype != torch.float32:
        raise ValueError(f"temporal_ss: need float32 current and velocity, "
                         f"got {current.dtype} and {velocity.dtype}")
    if history.dtype not in (torch.float16, torch.float32):
        raise ValueError(f"temporal_ss: need a float16 or float32 history, "
                         f"got {history.dtype}")
    if current.dim() != 3 or current.shape[-1] != 4:
        raise ValueError(f"temporal_ss: need an (H, W, 4) current, got "
                         f"{tuple(current.shape)}")
    h, w = current.shape[0], current.shape[1]
    if tuple(history.shape) != (h, w, 4) or \
            tuple(velocity.shape) != (h, w, 2):
        raise ValueError(f"temporal_ss: history {tuple(history.shape)} and "
                         f"velocity {tuple(velocity.shape)} for current "
                         f"{tuple(current.shape)}: need (H, W, 4) and "
                         f"(H, W, 2)")
    return h, w


def temporal_ss(current, history, velocity, full_size=None, row0=0):
    """TS wrapper: the CUDA kernel for CUDA tensors (or raise), the plain
    version for CPU tensors.  Launch counters count calls that launch the
    kernel: a frame captured into a CUDA graph (``Renderer.step_n``)
    counts once, at capture, not at each replay."""
    if current.device.type == "cpu":
        return temporal_ss_plain(current, history, velocity, full_size, row0)
    h, w = _check(current, history, velocity)
    fw, fh = full_size if full_size is not None else (w, h)
    out = torch.empty((h, w, 4), dtype=torch.float32, device=current.device)
    if h == 0 or w == 0:
        return out
    err = load_library().rtggx_temporal_ss(
        current.data_ptr(), *current.stride(), history.data_ptr(),
        *history.stride(), int(history.dtype == torch.float16),
        velocity.data_ptr(), *velocity.stride(), h, w, float(fw), float(fh),
        int(row0), out.data_ptr(), stream_handle(current.device))
    check_launch(err, "TS temporal_ss")
    temporal_ss.launches += 1
    return out


temporal_ss.launches = 0
