"""Flatten an LBVH into the DFS node stream with skip links, the tree
kernel K4 traverses.

Torch port of raytracedggx_tpu/ops/flatten.py.  Subtrees with at most
``leaf_size`` triangles collapse into leaves, and triangles are re-ordered
so that every leaf is a contiguous [tri_start, tri_start + tri_count)
range of the triangle stream.  A ray walks the nodes in order:

  node hit ? (leaf: test its triangles, then go to skip) | go to node + 1
           : go to skip (past the subtree)

Re-laid out for the GPU: the reference's lane-tiled (Nt, 9, 128) node and
triangle columns become (N, 9) and (T, 9) rows with no padding:
  nodes  (N, 9) f32: lo.xyz, hi.xyz, skip, tri_start, tri_count (the
         links are exact f32 integers, < 2^24)
  tris   (T, 9) f32: v0, e1, e2 in stream order
``tri_perm`` maps stream position -> original triangle id.
``from_reference_arrays`` converts the reference's arrays, so both sides
can trace one tree.

Beside them each tree keeps the copies kernel K4 reads as float4, built
from those rows by ``flatten_bvh``, ``from_reference_arrays`` and
``refit_flat_bvh`` alike: ``pairs`` (``pair_rows``: both children of an
internal node in one 64-byte row), ``tris4`` (each triangle's vectors
padded by a 0) and ``stack``, the tree's depth, by which the kernel's
stack is sized.  The plain version and the kernel's bound keep the
(N, 9) / (T, 9) rows.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch


class FlatBVH(NamedTuple):
    nodes: torch.Tensor        # (N, 9) float32
    tris: torch.Tensor         # (T, 9) float32, stream order
    tri_perm: torch.Tensor     # (T,) int64 stream -> original triangle id
    num_nodes: int
    # refit support: every DFS node covers a contiguous triangle-stream
    # range, answered as two power-of-two sparse-table windows
    refit_level: torch.Tensor  # (N,) int64
    refit_a: torch.Tensor      # (N,) int64
    refit_b: torch.Tensor      # (N,) int64
    links: torch.Tensor        # (N, 3) f32 static skip / start / count
    # K4's float4 copies of the rows above (ops/traverse_cuda.py)
    pairs: torch.Tensor        # (P, 16) f32 child-pair rows (pair_rows)
    tris4: torch.Tensor        # (T, 12) f32: v0 _ e1 _ e2 _
    stack: int                 # nodes on the longest root-to-leaf path


def subtree_counts(left, right, n):
    """Leaf count of every node of a radix tree (numpy, post-order by
    iterating to the fixed point; height <= 64)."""
    counts = np.ones(2 * n - 1, np.int64)
    for _ in range(64):
        new = counts[left] + counts[right]
        if np.array_equal(new, counts[:n - 1]):
            break
        counts[:n - 1] = new
    return counts


def subtree_leaves(node, left, right, leaf_tri, n_int):
    """Triangle ids of a subtree's leaves, left to right."""
    out, stack = [], [node]
    while stack:
        v = stack.pop()
        if v >= n_int:
            out.append(int(leaf_tri[v - n_int]))
        else:
            stack.append(right[v])
            stack.append(left[v])
    return out


def host_arrays(bvh):
    return tuple(x.cpu().numpy() for x in (bvh.left, bvh.right,
                                          bvh.aabb_min, bvh.aabb_max,
                                          bvh.leaf_tri))


def stream_rows(tri_v0, tri_e1, tri_e2, perm):
    """(T, 9) f32 rows v0 e1 e2 in stream order."""
    idx = torch.as_tensor(perm, dtype=torch.int64, device=tri_v0.device)
    return torch.cat([tri_v0[idx], tri_e1[idx], tri_e2[idx]], dim=1)


def float4_rows(tris):
    """(T, 9) rows v0 e1 e2 -> (T, 12): each vector padded to a float4
    with a 0, so K1, K4 and K5 read a triangle as three 16-byte loads.
    Pad slots keep v0 = NaN."""
    t = tris.reshape(-1, 3, 3)
    return torch.cat([t, torch.zeros_like(t[..., :1])], dim=2).reshape(-1, 12)


def float3_rows(tris4):
    """(T, 12) float4 rows -> the (T, 9) rows v0 e1 e2 they pad."""
    return tris4.reshape(-1, 3, 4)[..., :3].reshape(-1, 9)


def pair_rows(nodes):
    """(N, 9) DFS rows -> (P, 16) child-pair rows, one more than there
    are internal nodes.  Internal node i's children are node i + 1 and node
    skip(i + 1); the k-th internal node in DFS order gets row 1 + k, and
    row 0 holds the root as its first child beside an empty slot (a NaN
    box, which fails every slab test, and count -1).  Columns:
      0..5    first child's lo.xyz, hi.xyz;  6..11  the second's
      12, 13  first child: its pair row and 0 (internal), or tri_start and
              tri_count (leaf);  14, 15  the same for the second child."""
    f32 = torch.float32
    skip, start, count = nodes[:, 6].long(), nodes[:, 7], nodes[:, 8]
    internal = count == 0
    row_of = torch.cumsum(internal.long(), 0).to(f32)  # 1 + DFS rank
    left = torch.nonzero(internal).flatten() + 1

    def slot(c):
        leaf = count[c] > 0
        return nodes[c, 0:6], torch.stack(
            [torch.where(leaf, start[c], row_of[c]), count[c]], dim=1)

    box0, meta0 = slot(torch.cat([left.new_zeros(1), left]))
    box1, meta1 = slot(skip[left])
    box1 = torch.cat([box1.new_full((1, 6), float("nan")), box1])
    meta1 = torch.cat([meta1.new_tensor([[0.0, -1.0]]), meta1])
    return torch.cat([box0, box1, meta0, meta1], dim=1).contiguous()


def tree_depth(nodes) -> int:
    """Nodes on the longest root-to-leaf path of (N, 9) DFS rows (host
    side): node i's ancestors are the internal nodes j < i < skip(j)."""
    rows = np.asarray(nodes)
    skip, count = rows[:, 6].astype(np.int64), rows[:, 8]
    inner = np.nonzero(count == 0)[0]
    ancestors = np.zeros(rows.shape[0] + 1, np.int64)
    np.add.at(ancestors, inner + 1, 1)
    np.add.at(ancestors, skip[inner], -1)
    return int(np.cumsum(ancestors[:-1]).max()) + 1


def k4_rows(nodes, tris):
    """K4's float4 copies of the (N, 9) / (T, 9) rows: pairs, tris4 (the
    FlatBVH fields of those names)."""
    return dict(pairs=pair_rows(nodes), tris4=float4_rows(tris))


def flatten_bvh(bvh, tri_v0, tri_e1, tri_e2, leaf_size: int = 4) -> FlatBVH:
    """bvh: LBVH; tri data (T, 3) in ORIGINAL triangle order, on the
    device the result should live on.  The recursion runs on the host."""
    left, right, amin, amax, leaf_tri = host_arrays(bvh)
    n = len(leaf_tri)
    n_int = n - 1
    counts = subtree_counts(left, right, n)

    boxes, meta, ranges, tri_stream = [], [], [], []

    def emit(node):
        idx = len(boxes)
        boxes.append((amin[node], amax[node]))
        meta.append([0, 0, 0])
        ranges.append([len(tri_stream), 0])
        if node >= n_int or counts[node] <= leaf_size:
            tris = subtree_leaves(node, left, right, leaf_tri, n_int)
            meta[idx][1] = len(tri_stream)
            meta[idx][2] = len(tris)
            tri_stream.extend(tris)
        else:
            emit(left[node])
            emit(right[node])
        meta[idx][0] = len(boxes)          # skip: past the subtree
        ranges[idx][1] = len(tri_stream)
        return idx

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(10 ** 5)
    try:
        emit(0 if n > 1 else n_int)
    finally:
        sys.setrecursionlimit(old)

    N = len(boxes)
    node_arr = np.zeros((N, 9), np.float32)
    node_arr[:, 0:3] = [b[0] for b in boxes]
    node_arr[:, 3:6] = [b[1] for b in boxes]
    node_arr[:, 6:9] = np.asarray(meta, np.float32)

    rng = np.asarray(ranges, np.int64)
    length = np.maximum(rng[:, 1] - rng[:, 0], 1)
    level = np.floor(np.log2(length)).astype(np.int64)
    dev = tri_v0.device

    def t(x, dtype=torch.int64):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    nodes = t(node_arr, torch.float32)
    tris = stream_rows(tri_v0, tri_e1, tri_e2, tri_stream)
    return FlatBVH(nodes=nodes, tris=tris, tri_perm=t(tri_stream),
                   num_nodes=N, refit_level=t(level), refit_a=t(rng[:, 0]),
                   refit_b=t(rng[:, 1] - (1 << level)),
                   links=t(node_arr[:, 6:9], torch.float32),
                   **k4_rows(nodes, tris), stack=tree_depth(node_arr))


def refit_flat_bvh(flat: FlatBVH, positions, indices) -> FlatBVH:
    """Refit for deformed vertices, topology unchanged: per-triangle boxes
    in stream order, a log2(T) sparse min/max table, two windows per
    node, then the node and triangle rows and K4's copies of them again
    (the depth stays)."""
    pos = torch.as_tensor(positions, dtype=torch.float32,
                          device=flat.nodes.device)
    tri = torch.as_tensor(np.asarray(indices, np.int64),
                          device=pos.device).reshape(-1, 3)
    v = pos[tri][flat.tri_perm]                 # (T, 3, 3) stream order
    lo_tabs, hi_tabs = [v.amin(dim=1)], [v.amax(dim=1)]
    T = v.shape[0]
    k = 1
    while (1 << k) <= T:
        half, n_k = 1 << (k - 1), T - (1 << k) + 1
        lo_tabs.append(torch.minimum(lo_tabs[-1][:n_k],
                                     lo_tabs[-1][half:half + n_k]))
        hi_tabs.append(torch.maximum(hi_tabs[-1][:n_k],
                                     hi_tabs[-1][half:half + n_k]))
        k += 1

    N = flat.num_nodes
    lo = torch.zeros((N, 3), device=pos.device)
    hi = torch.zeros((N, 3), device=pos.device)
    for k in range(len(lo_tabs)):
        sel = (flat.refit_level == k)[:, None]
        a = torch.clamp(flat.refit_a, 0, lo_tabs[k].shape[0] - 1)
        b = torch.clamp(flat.refit_b, 0, lo_tabs[k].shape[0] - 1)
        lo = torch.where(sel, torch.minimum(lo_tabs[k][a], lo_tabs[k][b]),
                         lo)
        hi = torch.where(sel, torch.maximum(hi_tabs[k][a], hi_tabs[k][b]),
                         hi)
    nodes = torch.cat([lo, hi, flat.links], dim=1)
    tris = torch.cat([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], dim=1)
    return flat._replace(nodes=nodes, tris=tris, **k4_rows(nodes, tris))


def lane_rows(tiles, count, width):
    """Reference lane-tiled (Nt, width, 128) columns -> (count, width)."""
    return np.array(tiles, np.float32).transpose(0, 2, 1).reshape(
        -1, width)[:count]


def from_reference_arrays(nodes, tris, tri_perm, num_nodes, refit_level,
                          refit_a, refit_b, device=None) -> FlatBVH:
    """The port's FlatBVH from the reference FlatBVH's arrays as numpy:
    nodes (Nt, 9, 128), tris (Tt, 9, 128), tri_perm (T,), refit_* (N,)."""
    N, T = int(num_nodes), len(tri_perm)
    rows = lane_rows(nodes, N, 9)

    def t(x, dtype=torch.int64):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    nodes = t(rows, torch.float32)
    tris = t(lane_rows(tris, T, 9), torch.float32)
    return FlatBVH(nodes=nodes, tris=tris, tri_perm=t(tri_perm), num_nodes=N,
                   refit_level=t(refit_level), refit_a=t(refit_a),
                   refit_b=t(refit_b), links=t(rows[:, 6:9], torch.float32),
                   **k4_rows(nodes, tris), stack=tree_depth(rows))
