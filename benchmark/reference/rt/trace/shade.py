"""Material evaluation: procedural UV + checkerboard roughness.

Torch port of raytracedggx_tpu/trace/shade.py (Material.hlsli:16-49).
The reference's per-instance fetch is a one-hot matmul (``take_small``,
an MXU idiom); here it is a clamped index gather, which returns the same
rows.
"""

from __future__ import annotations

import torch


def take_small(table, idx):
    """Per-ray row fetch from a small per-instance table; misses (-1)
    read row 0, as the reference's clipped one-hot does."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1)]


def get_uv(nrm, pos, scl=(1.0, 0.2, 1.0)):
    """getUV (Material.hlsli:16-23). nrm/pos (..., 3) object space."""
    ax = torch.abs(nrm[..., 0:1])
    ay = torch.abs(nrm[..., 1:2])
    az = torch.abs(nrm[..., 2:3])
    yz = torch.stack([pos[..., 1] * scl[1], pos[..., 2] * scl[2]], dim=-1)
    zx = torch.stack([pos[..., 2] * scl[2], pos[..., 0] * scl[0]], dim=-1)
    xy = torch.stack([pos[..., 0] * scl[0], pos[..., 1] * scl[1]], dim=-1)
    uv = ax * yz + ay * zx + az * xy
    return uv * 0.5 + 0.5


def get_rough_metal(rough_metals, inst, uv):
    """getRoughMetal (Material.hlsli:43-49): per-instance roughness with
    the instance-0 checkerboard (uint truncation of uv*5, xor parity)."""
    rm = take_small(rough_metals, inst)
    rough, metal = rm[..., 0], rm[..., 1]
    # the reference's float -> uint32 conversion saturates (negatives -> 0)
    p = torch.clamp(uv * 5.0, 0.0, 4294967295.0).to(torch.int64) & 1
    checker = (p[..., 0] ^ p[..., 1]) != 0
    rough = torch.where((inst == 0) & checker, rough * 0.25, rough)
    return rough, metal


def get_base_color(base_colors, inst):
    return take_small(base_colors, inst)
