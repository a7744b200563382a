"""30-bit 3-D Morton codes.

Torch port of raytracedggx_tpu/bvh/morton.py.  The reference's uint32 bit
arithmetic runs in int64 with ``& 0xFFFFFFFF`` after every multiply (the
products stay below 2^42), which is bit-exact with it.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def expand_bits(v):
    """Spread the low 10 bits of each value to every 3rd bit."""
    v = v.to(torch.int64)
    v = ((v * 0x00010001) & MASK32) & 0xFF0000FF
    v = ((v * 0x00000101) & MASK32) & 0x0F00F00F
    v = ((v * 0x00000011) & MASK32) & 0xC30C30C3
    v = ((v * 0x00000005) & MASK32) & 0x49249249
    return v


def morton3d(points, lo, hi):
    """Morton codes (int64 holding uint32) for (N, 3) points normalized
    into the [lo, hi] AABB."""
    x = (points - lo) / torch.clamp(hi - lo, min=1e-20)
    q = torch.clamp(x * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((expand_bits(q[:, 0]) << 2) | (expand_bits(q[:, 1]) << 1)
            | expand_bits(q[:, 2]))
