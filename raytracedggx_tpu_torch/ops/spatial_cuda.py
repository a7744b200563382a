"""Spatial filter passes: kernels K2 (reflection) and K3 (diffuse) and
their plain twins.

Counterpart of raytracedggx_tpu/ops/spatial_pallas.py (the '[V]' toggle
variant) and of the stencils ``_reflection_pass`` / ``_diffuse_pass`` in
raytracedggx_tpu/denoise/spatial.py (the direct variant), which are the
plain versions here.  The CUDA kernels (csrc/spatial.cu) stage a tile of
the channel-last (H, W, C) tensors with its 16-pixel halo in shared memory
and run the 33 taps from there, with a row kernel and a column kernel in
place of the TPU's transposed planes; out-of-bounds taps are zero-filled
as the reference pads them (the hit gate is 0 there).  K2 reads its
Gaussian weights from ``gaussian_table``; K3 computes four consecutive
outputs per thread and its power 32 by five squarings.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..utils.math3d import smoothstep
from .cuda_lib import check_launch, load_library, stream_handle

RADIUS = 16
SIGMA_Z = 4.0


def gaussian_radius(rough, width, height):
    """GaussianRadiusFromRoughness (FilterCommon.hlsli:49-52): int clamp,
    from the full image's width and height for both axes."""
    return torch.clamp(0.1 * rough * width, 0.0, height * 0.05
                       ).to(torch.int32).to(torch.float32)


def gaussian_table(br_max, device):
    """(floor(br_max) + 1, 17) f32: row br, column |i| holds the plain
    pass's Gaussian weight exp(-0.5 * (|i| / sigma)^2), sigma = (br + 1) / 3,
    with its arithmetic (float32 reciprocal and multiplies, torch.exp), so
    K2's weights equal the plain version's bit for bit on the same device.
    Built once per (floor(br_max), device)."""
    return _gaussian_table(int(br_max) + 1, torch.device(device))


@functools.lru_cache(maxsize=None)
def _gaussian_table(n_br, device):
    # the plain pass's |i| / sigma is torch's scalar / tensor, which is
    # reciprocal(sigma) * |i|
    sigma = (torch.arange(n_br, dtype=torch.float32, device=device)
             + 1.0) / 3.0
    i = torch.arange(RADIUS + 1, dtype=torch.float32, device=device)
    a = sigma.reciprocal()[:, None] * i
    return torch.exp(-0.5 * a * a)


def _taps(x, axis):
    """The 33 zero-filled shifts of an (H, W, ...) tensor along ``axis``:
    tap i reads x at offset i (out-of-bounds reads are zeros)."""
    pad = [0, 0] * (x.dim() - 1 - axis) + [RADIUS, RADIUS]
    xp = F.pad(x, pad)
    n = x.shape[axis]
    return [xp.narrow(axis, RADIUS + i, n) for i in range(-RADIUS, RADIUS + 1)]


def reflection_pass_plain(src_tm, normal, rough, depth, width, height, axis):
    """Plain K2: one separable reflection pass over the tone-mapped
    source (H, W, 3) (port of denoise/spatial.py:_reflection_pass)."""
    n_c = normal[..., :3] * 2.0 - 1.0
    sigma = (gaussian_radius(rough, width, height) + 1.0) / 3.0
    mu = torch.zeros_like(src_tm)
    wsum = torch.zeros_like(rough)
    taps = zip(range(-RADIUS, RADIUS + 1), _taps(normal, axis),
               _taps(src_tm, axis), _taps(depth, axis), _taps(rough, axis))
    for i, nrm, s, dep, rgh in taps:
        n = nrm[..., :3] * 2.0 - 1.0
        a = float(abs(i)) / sigma
        w = torch.where(nrm[..., 3] > 0.0, 1.0, 0.0)
        w = w * torch.exp(-0.5 * a * a)
        # clip: out-of-bounds taps decode to n=(-1,-1,-1) whose dot can
        # exceed 1, and x^512 would overflow (their gate is zero)
        w = w * torch.clamp(torch.sum(n_c * n, dim=-1), 0.0, 1.0) ** 512.0
        w = w * torch.exp(-torch.abs(depth - dep) * depth * SIGMA_Z)
        w = w * (1.0 - smoothstep(0.0, 0.5, torch.abs(rgh - rough)))
        mu = mu + s * w[..., None]
        wsum = wsum + w
    return mu / torch.clamp(wsum, min=1e-30)[..., None]


def diffuse_pass_plain(src_tm, normal, metal, depth, axis):
    """Plain K3: one separable diffuse pass (port of
    denoise/spatial.py:_diffuse_pass)."""
    n_c = normal[..., :3] * 2.0 - 1.0
    mu = torch.zeros_like(src_tm)
    wsum = torch.zeros_like(metal)
    taps = zip(_taps(normal, axis), _taps(src_tm, axis), _taps(depth, axis),
               _taps(metal, axis))
    for nrm, s, dep, mtl in taps:
        n = nrm[..., :3] * 2.0 - 1.0
        w = torch.where((nrm[..., 3] > 0.0) & (mtl < 1.0), 1.0, 0.0)
        w = w * torch.clamp(torch.sum(n_c * n, dim=-1), 0.0, 1.0) ** 32.0
        w = w * torch.exp(-torch.abs(depth - dep) * depth * SIGMA_Z)
        mu = mu + s * w[..., None]
        wsum = wsum + w
    return mu / torch.clamp(wsum, min=1e-30)[..., None]


def _outputs(src_tm, normal, aux, depth, axis):
    """Check a K2 or K3 launch's inputs and allocate its (H, W, 3) output."""
    H, W = src_tm.shape[0], src_tm.shape[1]
    dev = src_tm.device
    for name, t, shape in (("src_tm", src_tm, (H, W, 3)),
                           ("normal", normal, (H, W, 4)),
                           ("rough/metal", aux, (H, W)),
                           ("depth", depth, (H, W))):
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"{name}: need a contiguous float32 {shape} "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    return torch.empty((H, W, 3), dtype=torch.float32, device=dev)


def reflection_pass(src_tm, normal, rough, depth, width, height, axis):
    """K2 wrapper: the CUDA kernel for CUDA tensors (or raise), the plain
    version for CPU tensors.
    Launch counters count calls that launch the kernel: a frame
    captured into a CUDA graph (``Renderer.step_n``) counts once, at
    capture, not at each replay."""
    if src_tm.device.type == "cpu":
        return reflection_pass_plain(src_tm, normal, rough, depth, width,
                                     height, axis)
    out = _outputs(src_tm, normal, rough, depth, axis)
    br_max = float(height * 0.05)
    table = gaussian_table(br_max, src_tm.device)
    err = load_library().rtggx_reflection_pass(
        int(axis), src_tm.data_ptr(), normal.data_ptr(), rough.data_ptr(),
        depth.data_ptr(), table.data_ptr(), table.shape[0], out.data_ptr(),
        out.shape[0], out.shape[1], float(width), br_max,
        stream_handle(src_tm.device))
    check_launch(err, "K2 reflection_pass")
    reflection_pass.launches += 1
    return out


def diffuse_pass(src_tm, normal, metal, depth, axis):
    """K3 wrapper: the CUDA kernel for CUDA tensors (or raise), the plain
    version for CPU tensors.
    Launch counters count calls that launch the kernel: a frame
    captured into a CUDA graph (``Renderer.step_n``) counts once, at
    capture, not at each replay."""
    if src_tm.device.type == "cpu":
        return diffuse_pass_plain(src_tm, normal, metal, depth, axis)
    out = _outputs(src_tm, normal, metal, depth, axis)
    err = load_library().rtggx_diffuse_pass(
        int(axis), src_tm.data_ptr(), normal.data_ptr(),
        metal.data_ptr(), depth.data_ptr(), out.data_ptr(), out.shape[0],
        out.shape[1], stream_handle(src_tm.device))
    check_launch(err, "K3 diffuse_pass")
    diffuse_pass.launches += 1
    return out


reflection_pass.launches = 0
diffuse_pass.launches = 0
