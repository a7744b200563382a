"""Per-mesh 4-wide BVH: build, kernel K5 and its plain twin.

Torch/CUDA port of raytracedggx_tpu/ops/wide.py:35-163 (``WideBVH``,
``build_records4``, ``flatten_bvh4``) and :270-354 (``trace_tiles4``,
``trace_rays_pallas4``, ``trace_scene_pallas4``), the
``traversal="pallas4"`` backend.  The TPU kernel ``_kernel`` becomes the
CUDA kernel in ``csrc/traverse_wide4.cu``, launched by ``trace_tiles4``
with one ray per thread and its own stack in shared memory; its plain
version is the brute-force ``trace_stream_plain`` (ops/traverse_cuda.py).

Re-laid out for the GPU: the reference's lane-tiled (Nt, 36, 128)
supernode columns become (N, 36) rows with K1's row layout,
  cols 0..23   4 children x (lo.xyz, hi.xyz); empty: +inf / -inf
  cols 24..27  child kind: 0 empty, 1 leaf, 2 internal
  cols 28..31  supernode index (internal) / tri_start (leaf)
  cols 32..35  tri_count (leaf) / 0
and the (Tt, 9, 128) triangle columns (T, 9) stream rows, beside which
the build keeps ``tris4``, the same rows with each of v0, e1, e2 padded
to a float4 by a 0: the kernel reads a triangle as three 16-byte loads,
while the plain version and the kernel's bound keep the (T, 9) rows.  The
build also records the tree's stack bound, 3 * depth + 1, by which the
wrapper sizes the kernel's shared-memory stack and which it holds against
the kernel's compiled maximum (the reference's 64-entry SMEM stack has no
overflow check).
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from ..trace.traverse import HitRecord
from .cuda_lib import check_launch, load_library, pointer, stream_handle
from .flatten import (float4_rows, host_arrays, lane_rows, stream_rows,
                      subtree_counts, subtree_leaves)
from .traverse_cuda import (check_stack, launch_outputs, per_ray,
                            trace_rays_tree, trace_scene_trees,
                            trace_stream_plain)


class WideBVH(NamedTuple):
    nodes: torch.Tensor     # (N, 36) float32
    tris: torch.Tensor      # (T, 9) float32, stream order
    tris4: torch.Tensor     # (T, 12) float32: K5's copy, v0 _ e1 _ e2 _
    tri_perm: torch.Tensor  # (T,) int64 stream -> original triangle id
    num_nodes: int
    stack: int              # 3 * depth + 1: the deepest stack a ray needs


def build_records4(bvh, leaf_size: int = 4):
    """Collapse a binary LBVH into 4-wide supernode records (host side).
    Returns (records, tri_stream): records[i] = list of child dicts
    {kind, lo, hi, a, b}; tri_stream = stream position -> original
    triangle id.  Every child covers a contiguous tri_stream range."""
    left, right, amin, amax, leaf_tri = host_arrays(bvh)
    n = len(leaf_tri)
    n_int = n - 1
    counts = subtree_counts(left, right, n)

    def leaves_of(node):
        return subtree_leaves(node, left, right, leaf_tri, n_int)

    def expand4(node):
        """Binary node -> up to 4 subtree roots (children/grandchildren)."""
        kids = [left[node], right[node]]
        while len(kids) < 4:
            # split the expandable child with the largest subtree
            best, best_c = -1, leaf_size
            for i, k in enumerate(kids):
                if k < n_int and counts[k] > best_c:
                    best, best_c = i, counts[k]
            if best < 0:
                break
            k = kids.pop(best)
            kids[best:best] = [left[k], right[k]]
        return kids

    records, tri_stream = [], []

    def emit(node):
        idx = len(records)
        records.append(None)
        childs = []
        for k in expand4(node):
            if k >= n_int or counts[k] <= leaf_size:
                tris = leaves_of(k)
                childs.append(dict(kind=1, lo=amin[k], hi=amax[k],
                                   a=len(tri_stream), b=len(tris)))
                tri_stream.extend(tris)
            else:
                childs.append(dict(kind=2, lo=amin[k], hi=amax[k],
                                   a=None, b=0, node=k))
        records[idx] = childs
        for c in childs:
            if c["kind"] == 2:
                c["a"] = emit(c["node"])
        return idx

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(10 ** 5)
    try:
        if n == 1 or counts[0] <= leaf_size:
            tris = leaves_of(0 if n > 1 else n_int)
            records.append([dict(kind=1, lo=amin[0], hi=amax[0],
                                 a=0, b=len(tris))])
            tri_stream.extend(tris)
        else:
            emit(0)
    finally:
        sys.setrecursionlimit(old)
    return records, tri_stream


def flatten_bvh4(bvh, tri_v0, tri_e1, tri_e2, leaf_size: int = 4) -> WideBVH:
    """bvh: LBVH; tri data (T, 3) in ORIGINAL order, on the device the
    result should live on."""
    records, tri_stream = build_records4(bvh, leaf_size)
    N = len(records)
    arr = np.zeros((N, 36), np.float32)
    for k in range(4):                  # empty slots never hit
        arr[:, k * 6:k * 6 + 3] = np.inf
        arr[:, k * 6 + 3:k * 6 + 6] = -np.inf
    for i, childs in enumerate(records):
        for k, c in enumerate(childs):
            arr[i, k * 6:k * 6 + 3] = c["lo"]
            arr[i, k * 6 + 3:k * 6 + 6] = c["hi"]
            arr[i, 24 + k], arr[i, 28 + k], arr[i, 32 + k] = (
                c["kind"], c["a"], c["b"])
    tris = stream_rows(tri_v0, tri_e1, tri_e2, tri_stream)
    return WideBVH(nodes=torch.as_tensor(arr, device=tri_v0.device),
                   tris=tris, tris4=float4_rows(tris),
                   tri_perm=torch.as_tensor(tri_stream, dtype=torch.int64,
                                            device=tri_v0.device),
                   num_nodes=N, stack=stack_bound(arr))


def stack_bound(nodes) -> int:
    """3 * depth + 1 of a (N, 36) supernode table (host side; children
    come after their parents)."""
    rows = np.asarray(nodes)
    kind, a = rows[:, 24:28].astype(np.int64), rows[:, 28:32].astype(np.int64)
    depth = np.ones(rows.shape[0], np.int64)
    for i in range(rows.shape[0] - 1, -1, -1):
        for k in range(4):
            if kind[i, k] == 2:
                depth[i] = max(depth[i], 1 + depth[a[i, k]])
    return int(3 * depth[0] + 1)


def from_reference_arrays(nodes, tris, tri_perm, num_nodes,
                          device=None) -> WideBVH:
    """The port's WideBVH from the reference WideBVH's arrays as numpy:
    nodes (Nt, 36, 128), tris (Tt, 9, 128), tri_perm (T,)."""
    rows = lane_rows(nodes, int(num_nodes), 36)
    tris = torch.as_tensor(lane_rows(tris, len(tri_perm), 9), device=device)
    return WideBVH(
        nodes=torch.as_tensor(rows, device=device), tris=tris,
        tris4=float4_rows(tris),
        tri_perm=torch.as_tensor(np.array(tri_perm), dtype=torch.int64,
                                 device=device),
        num_nodes=int(num_nodes), stack=stack_bound(rows))


def trace_tiles4(wide: WideBVH, ray_o, ray_d, t_min, t_max, inv=None,
                 stats=None):
    """K5 wrapper: closest hit of (R, 3) rays against one WideBVH, in the
    object space of ``inv`` ((12,) inverse-world row, or None).  CUDA
    tensors launch the kernel (or raise: a tree whose stack bound
    ``wide.stack`` exceeds the kernel's compiled 64, or node and ``tris4``
    rows that are not 16-byte aligned); CPU tensors take
    ``trace_stream_plain``.  Returns (t, u, v, stream position int32).
    stats: optional (2,) int64 tensor for box and triangle tests.
    Launch counters count calls that launch the kernel: a frame
    captured into a CUDA graph (``Renderer.step_n``) counts once, at
    capture, not at each replay."""
    t_max = per_ray(t_max, ray_o)
    if ray_o.device.type == "cpu":
        return trace_stream_plain(wide.tris, ray_o, ray_d, t_min, t_max,
                                  inv)
    out = launch_outputs(ray_o, ray_d, inv, stats, {
        "nodes": (wide.nodes, (wide.num_nodes, 36)),
        "tris4": (wide.tris4, (wide.tris.shape[0], 12))})
    lib = load_library()
    check_stack("K5", wide.stack, lib.rtggx_k5_max_stack())
    err = lib.rtggx_trace_wide4(
        wide.nodes.data_ptr(), wide.tris4.data_ptr(), pointer(inv),
        ray_o.data_ptr(), ray_d.data_ptr(), t_max.data_ptr(), float(t_min),
        ray_o.shape[0], int(wide.stack), *(x.data_ptr() for x in out),
        pointer(stats), stream_handle(ray_o.device))
    check_launch(err, "K5 trace_tiles4")
    trace_tiles4.launches += 1
    return out


trace_tiles4.launches = 0


def trace_rays4(wide: WideBVH, ray_o, ray_d, t_min, t_max, inv=None,
                impl: str = "cuda") -> HitRecord:
    """Closest hit against one WideBVH (K5; trace_rays_pallas4)."""
    return trace_rays_tree(trace_tiles4, wide, ray_o, ray_d, t_min, t_max,
                           inv, impl)


def trace_scene4(wides, tlas, ray_o, ray_d, t_min, t_max,
                 impl: str = "cuda") -> HitRecord:
    """Closest hit across the TLAS instances, one K5 launch each
    (trace_scene_pallas4)."""
    return trace_scene_trees(trace_tiles4, wides, tlas, ray_o, ray_d, t_min,
                             t_max, impl)
