"""Host-side binned-SAH BVH builder for STATIC object-space meshes.

The reference gets its BLAS quality from the DXR driver's builder
(`BottomLevelAS::Build` with PREFER_FAST_TRACE, XUSGRayTracing.h:163-190,
RayTracer.cpp:697-709).  Our on-device Karras LBVH (bvh/lbvh.py) is the
refit-friendly analog, but Morton-order topology costs incoherent
(reflection/diffuse) waves ~1.5-2x more node+leaf visits than a surface-
area-heuristic tree.  The object-space mesh subtrees of the instanced
scene BVH (ops/scene_wide.py) are built ONCE and never refit — instance
animation only moves their world boxes — so they can afford a real SAH
build on the host at load time.

Output is LBVH-layout-compatible (same node-id convention:
internal nodes [0, n-2] with root 0, leaf k at node (n-1)+k holding
triangle ``leaf_tri[k]``) so ops/fused.build_records4_padded consumes it
unchanged.

Algorithm: classic binned SAH (Wald 2007) — 16 centroid bins per axis,
split plane minimizing  SA_L * N_L + SA_R * N_R ; below ``chain_cutoff``
triangles the subtree is emitted as a right-leaning singleton chain (the
4-wide collapse in build_records4_padded turns any subtree with <= L
triangles into one padded leaf, so sub-leaf topology is never traversed
— only its root box and triangle set matter).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

BINS = 16


class CpuBVH(NamedTuple):
    """numpy twin of bvh.lbvh.LBVH (same node-id layout)."""
    left: np.ndarray       # (n-1,) int32
    right: np.ndarray      # (n-1,) int32
    aabb_min: np.ndarray   # (2n-1, 3) float32
    aabb_max: np.ndarray   # (2n-1, 3) float32
    leaf_tri: np.ndarray   # (n,) int32

    @property
    def num_leaves(self):
        return self.leaf_tri.shape[0]


def _half_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] \
        + d[..., 2] * d[..., 0]


def build_sah(positions, indices, chain_cutoff: int = 16) -> CpuBVH:
    """positions (V, 3), indices (T, 3) or (3T,) -> CpuBVH.

    chain_cutoff: subtrees at or below this triangle count are emitted as
    singleton chains without SAH evaluation; choose it <= the supernode
    collapse leaf_size so chain interiors are never traversed."""
    tri = np.asarray(indices, np.int64).reshape(-1, 3)
    pos = np.asarray(positions, np.float64)
    v = pos[tri]                                   # (T, 3, 3)
    t_lo = v.min(axis=1).astype(np.float32)
    t_hi = v.max(axis=1).astype(np.float32)
    cent = ((t_lo + t_hi) * 0.5).astype(np.float32)
    T = tri.shape[0]
    if T == 0:
        raise ValueError("empty mesh")
    if T == 1:
        return CpuBVH(left=np.zeros((0,), np.int32),
                      right=np.zeros((0,), np.int32),
                      aabb_min=t_lo, aabb_max=t_hi,
                      leaf_tri=np.zeros((1,), np.int32))

    n_int = T - 1
    left = np.zeros(n_int, np.int32)
    right = np.zeros(n_int, np.int32)
    amin = np.zeros((2 * T - 1, 3), np.float32)
    amax = np.zeros((2 * T - 1, 3), np.float32)
    leaf_tri = np.zeros(T, np.int32)

    next_int = [0]          # internal node id allocator (root = 0)
    next_leaf = [0]         # leaf ordinal allocator

    def alloc_int():
        i = next_int[0]
        next_int[0] += 1
        return i

    def node_box(node, idx):
        amin[node] = t_lo[idx].min(axis=0)
        amax[node] = t_hi[idx].max(axis=0)

    def emit_chain(node, idx):
        """Right-leaning singleton chain under `node` (count >= 2).
        Interior chain boxes = subtree box (never traversed: the 4-wide
        collapse leafs any subtree with <= leaf_size triangles)."""
        node_box(node, idx)
        lo, hi = amin[node], amax[node]
        for k in range(len(idx) - 1):
            t = idx[k]
            lf = n_int + next_leaf[0]
            leaf_tri[next_leaf[0]] = t
            amin[lf] = t_lo[t]
            amax[lf] = t_hi[t]
            next_leaf[0] += 1
            left[node] = lf
            if k == len(idx) - 2:
                t2 = idx[k + 1]
                lf2 = n_int + next_leaf[0]
                leaf_tri[next_leaf[0]] = t2
                amin[lf2] = t_lo[t2]
                amax[lf2] = t_hi[t2]
                next_leaf[0] += 1
                right[node] = lf2
            else:
                child = alloc_int()
                right[node] = child
                amin[child] = lo
                amax[child] = hi
                node = child

    # iterative build (explicit stack; meshes reach ~1M tris)
    root = alloc_int()
    stack = [(root, np.arange(T, dtype=np.int64))]
    while stack:
        node, idx = stack.pop()
        cnt = len(idx)
        if cnt <= max(chain_cutoff, 2):
            emit_chain(node, idx)
            continue
        node_box(node, idx)

        c = cent[idx]
        c_lo = c.min(axis=0)
        c_hi = c.max(axis=0)
        ext = c_hi - c_lo

        best = None  # (cost, axis, bin_id, bin_of)
        for ax in range(3):
            if ext[ax] <= 0.0:
                continue
            scale = BINS * (1.0 - 1e-6) / ext[ax]
            b = ((c[:, ax] - c_lo[ax]) * scale).astype(np.int32)
            counts = np.bincount(b, minlength=BINS)
            # per-bin bounds via reduceat over bin-sorted order
            o = np.argsort(b, kind="stable")
            lo_s = t_lo[idx][o]
            hi_s = t_hi[idx][o]
            starts = np.zeros(BINS, np.int64)
            starts[1:] = np.cumsum(counts)[:-1]
            nz = counts > 0
            big = np.float32(3e38)
            b_lo = np.full((BINS, 3), big, np.float32)
            b_hi = np.full((BINS, 3), -big, np.float32)
            red = np.minimum.reduceat(lo_s, starts[nz], axis=0)
            b_lo[nz] = red
            b_hi[nz] = np.maximum.reduceat(hi_s, starts[nz], axis=0)
            # prefix/suffix unions over bins
            p_lo = np.minimum.accumulate(b_lo, axis=0)
            p_hi = np.maximum.accumulate(b_hi, axis=0)
            s_lo = np.minimum.accumulate(b_lo[::-1], axis=0)[::-1]
            s_hi = np.maximum.accumulate(b_hi[::-1], axis=0)[::-1]
            n_l = np.cumsum(counts)[:-1]
            n_r = cnt - n_l
            cost = (n_l * _half_area(p_lo[:-1], p_hi[:-1])
                    + n_r * _half_area(s_lo[1:], s_hi[1:]))
            cost = np.where((n_l > 0) & (n_r > 0), cost, np.inf)
            k = int(np.argmin(cost))
            if np.isfinite(cost[k]) and (best is None
                                         or cost[k] < best[0]):
                best = (cost[k], ax, k, b)

        if best is None:
            # degenerate (all centroids identical): split halves
            mask = np.zeros(cnt, bool)
            mask[: cnt // 2] = True
        else:
            _, ax, k, b = best
            mask = b <= k
        l_idx = idx[mask]
        r_idx = idx[~mask]

        for side, s_idx in (("l", l_idx), ("r", r_idx)):
            if len(s_idx) == 1:
                t = s_idx[0]
                lf = n_int + next_leaf[0]
                leaf_tri[next_leaf[0]] = t
                amin[lf] = t_lo[t]
                amax[lf] = t_hi[t]
                next_leaf[0] += 1
                child = lf
            else:
                child = alloc_int()
                stack.append((child, s_idx))
            if side == "l":
                left[node] = child
            else:
                right[node] = child

    assert next_int[0] == n_int and next_leaf[0] == T
    return CpuBVH(left=left, right=right, aabb_min=amin, aabb_max=amax,
                  leaf_tri=leaf_tri)
