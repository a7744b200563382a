"""The spatial filters' plain passes (the port's ``reflection_pass_plain``
and ``diffuse_pass_plain``, the plain twins of kernels K2 and K3),
copied unchanged: a 33-tap edge-aware stencil per axis."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.math3d import smoothstep

RADIUS = 16
SIGMA_Z = 4.0


def gaussian_radius(rough, width, height):
    """GaussianRadiusFromRoughness (FilterCommon.hlsli:49-52): int clamp,
    from the full image's width and height for both axes."""
    return torch.clamp(0.1 * rough * width, 0.0, height * 0.05
                       ).to(torch.int32).to(torch.float32)


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
