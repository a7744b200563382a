"""LBVH: the Karras 2012 radix tree over sorted Morton codes.

Torch port of raytracedggx_tpu/bvh/lbvh.py with the same topology: the
Morton codes are bit-exact (morton.py), the sort is stable as
``jnp.argsort`` is, and ``clz32`` counts leading zeros exactly in int64
(torch has no clz), including the index tie-break ``32 + clz(i ^ j)``.

Node layout: internal nodes [0, n-2], leaves [n-1, 2n-2]; leaf k holds
original triangle ``leaf_tri[k]``.  Root is node 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .morton import morton3d

MAX_DEPTH = 64


class LBVH(NamedTuple):
    left: torch.Tensor      # (n-1,) int64 child node ids
    right: torch.Tensor     # (n-1,) int64
    aabb_min: torch.Tensor  # (2n-1, 3) float32
    aabb_max: torch.Tensor  # (2n-1, 3) float32
    leaf_tri: torch.Tensor  # (n,) int64: leaf k -> original triangle id

    @property
    def num_leaves(self):
        return self.leaf_tri.shape[0]

    @property
    def num_internal(self):
        return self.left.shape[0]


def clz32(x):
    """Leading zeros of 32-bit unsigned values held in int64 (32 for 0)."""
    n = torch.zeros_like(x)
    for bits, limit in ((16, 0xFFFF), (8, 0xFFFFFF), (4, 0xFFFFFFF),
                        (2, 0x3FFFFFFF), (1, 0x7FFFFFFF)):
        small = x <= limit
        n = torch.where(small, n + bits, n)
        x = torch.where(small, x << bits, x)
    return torch.where(x == 0, n + 1, n)


def _build_radix_tree(keys):
    """(left, right) children of internal nodes 0..n-2 of the binary radix
    tree over sorted ``keys`` (uint32 in int64); ties by index."""
    n = keys.shape[0]
    i = torch.arange(n - 1, dtype=torch.int64, device=keys.device)

    def delta(j):
        valid = (j >= 0) & (j < n)
        jc = torch.clamp(j, 0, n - 1)
        x = keys[i] ^ keys[jc]
        d = torch.where(x == 0, 32 + clz32(i ^ jc), clz32(x))
        return torch.where(valid, d, -1)

    d = torch.where(delta(i + 1) >= delta(i - 1), 1, -1)
    dmin = delta(i - d)

    # upper bound for the range length (doubling with a done mask)
    lmax = torch.full_like(i, 2)
    done = torch.zeros_like(i, dtype=torch.bool)
    for _ in range(32):
        c = delta(i + lmax * d) > dmin
        lmax = torch.where(c & ~done, lmax * 2, lmax)
        done = done | ~c

    # binary search for the other end j = i + l*d
    l = torch.zeros_like(i)
    for k in range(31):
        t = lmax >> (k + 1)
        c = (t >= 1) & (delta(i + (l + t) * d) > dmin)
        l = torch.where(c, l + t, l)
    j = i + l * d

    # split point by ceil-halving, stopping after the first t == 1 step
    dnode = delta(j)
    s = torch.zeros_like(i)
    sdone = torch.zeros_like(i, dtype=torch.bool)
    for k in range(31):
        t = torch.where(l > 0, ((l - 1) >> (k + 1)) + 1, 0)
        t = torch.where(sdone, 0, t)
        c = (t >= 1) & (delta(i + (s + t) * d) > dnode)
        s = torch.where(c, s + t, s)
        sdone = sdone | (t <= 1)

    gamma = i + s * d + torch.clamp(d, max=0)
    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    left = torch.where(lo == gamma, gamma + (n - 1), gamma)
    right = torch.where(hi == gamma + 1, gamma + 1 + (n - 1), gamma + 1)
    return left, right


def _union_pass(left, right, aabb_min, aabb_max):
    """parent = union(children), MAX_DEPTH rounds (height <= 64)."""
    n_int = left.shape[0]
    amin, amax = aabb_min.clone(), aabb_max.clone()
    for _ in range(MAX_DEPTH):
        amin[:n_int] = torch.minimum(amin[left], amin[right])
        amax[:n_int] = torch.maximum(amax[left], amax[right])
    return amin, amax


def build_lbvh(positions, indices) -> LBVH:
    """LBVH over triangles (positions (V, 3) f32, indices (3T,)), on the
    positions' device.  Requires T >= 2."""
    pos = torch.as_tensor(positions, dtype=torch.float32)
    tri = torch.as_tensor(indices, device=pos.device).to(
        torch.int64).reshape(-1, 3)
    v = pos[tri]                                    # (T, 3, 3)
    tmin = v.amin(dim=1)
    tmax = v.amax(dim=1)
    centroid = (tmin + tmax) * 0.5
    codes = morton3d(centroid, tmin.amin(dim=0), tmax.amax(dim=0))
    order = torch.sort(codes, stable=True).indices
    left, right = _build_radix_tree(codes[order])

    n = tri.shape[0]
    inf = torch.full((n - 1, 3), torch.inf, device=pos.device)
    aabb_min, aabb_max = _union_pass(left, right,
                                     torch.cat([inf, tmin[order]]),
                                     torch.cat([-inf, tmax[order]]))
    return LBVH(left, right, aabb_min, aabb_max, order)
