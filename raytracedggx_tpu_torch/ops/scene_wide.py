"""Unified instanced scene BVH: build, per-frame refit and the fused
closest-hit wrapper.

Torch port of raytracedggx_tpu/ops/scene_wide.py.  A small top tree over
INSTANCE world boxes enters shared per-MESH object-space subtrees through
tagged instance nodes (kind 3); the traversal kernel (K1, ops/fused.py)
transforms each ray by the tag's inverse world on a tag change.
``trace_scene_wide_fused`` runs K1 in the reference's three modes: lean
(the default), slim (``slim=True``: the kernel keeps only t, slot and
inst, and kernel K1e recomputes u, v from the slot) and fat (a tree built
with ``lean=False``: the kernel interpolates the normal and takes prim).

Re-laid out for the GPU: the reference's lane-tiled (Nt, 36, 128) node
columns become (N, 36) rows, and its (Lt, 9L, 128) leaf columns become
(S, 9) stream-slot rows (slot = leaf * L + k).  K1 reads a copy of the
slots with 48-byte rows, (S, 12): v0, e1, e2 each padded to a float4, so
a triangle is three 16-byte loads; the fat mode reads the attrs rows the
same way, (S, 12) ``attrs4``, which only a fat tree carries.  The
reference's fat 19L leaf columns are not kept: every tree has the (S, 10)
attrs table, and ``lean`` picks the mode.  ``from_reference_arrays`` converts the reference's arrays, lean
or fat, so both sides can trace one BVH.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..bvh.lbvh import build_lbvh
from ..bvh.sah import build_sah
from ..trace.traverse import HitRecord
from .flatten import float4_rows
from .fused import (attrs4_rows, build_records4_padded, slim_uv,
                    slot_normals, trace_tiles_instanced)

TAG_SHIFT = 20                      # stack entry = node | (tag << 20)
MAX_NODES = 1 << TAG_SHIFT
BIG = 3e38


class SceneWideBVH(NamedTuple):
    nodes: torch.Tensor         # (N, 36) f32: boxes 24 | kind 4 | a 4 | b 4
    tris: torch.Tensor          # (S, 9) f32 static object-space slots
    tris4: torch.Tensor         # (S, 12) f32 K1's copy: v0 _ e1 _ e2 _
    inv_mats: torch.Tensor      # (1 + I, 12) f32 inverse worlds (refit)
    attrs: torch.Tensor         # (S, 10) f32: n0 n1 n2 | prim per slot
    attrs4: torch.Tensor        # (S, 12) f32 K1f's copy, attrs | 0 0; None
    #                             on a lean tree
    static_cols: torch.Tensor   # (N, 12) f32 kind | a | b
    mesh_boxes: torch.Tensor    # (N - n_top, 24) f32 object-space boxes
    root_corners: torch.Tensor  # (I, 8, 3) mesh-root object box corners
    inst_slots: tuple           # per instance: (S_i,) int64 stream slots
    top_children: tuple         # per top node: (kind, a, b) per child
    n_top: int
    num_nodes: int
    leaf_size: int
    stack: int                  # the reference's bound (two-pop DFS)
    k1_stack: int               # K1's bound: near-first DFS, 3 * depth + 1
    depth: int                  # nodes on the longest root-to-leaf path
    lean: bool = True           # False: trace_scene_wide_fused runs K1f


def _instance_tree(num_inst: int):
    """4-ary grouping of instance indices into top-level records
    (preorder; children have larger indices than their parents)."""
    if num_inst <= 4:
        return [[("inst", i) for i in range(num_inst)]]
    level = [("inst", i) for i in range(num_inst)]
    while len(level) > 4:
        level = [("group", level[i:i + 4]) for i in range(0, len(level), 4)]
    records = []

    def emit(children):
        idx = len(records)
        records.append(None)
        records[idx] = [("inst", c[1]) if c[0] == "inst" else ("node", None)
                        for c in children]
        for k, c in enumerate(children):
            if c[0] != "inst":
                records[idx][k] = ("node", emit(c[1]))
        return idx

    emit(level)
    return records


def _derived(kind, a_col, b_col, boxes, n_top, num_inst, L):
    """(root_corners (I, 8, 3), inst_slots) from the node table: each
    instance's mesh-root box corners and the stream slots of every leaf
    under its kind-3 entry."""
    corners = np.zeros((num_inst, 8, 3), np.float32)
    slots = [None] * num_inst
    for r in range(n_top):
        for k in range(4):
            if kind[r, k] != 3:
                continue
            inst, root = int(b_col[r, k]) - 1, int(a_col[r, k])
            live = kind[root] > 0
            ch = boxes[root].reshape(4, 6)[live]
            lo, hi = ch[:, 0:3].min(axis=0), ch[:, 3:6].max(axis=0)
            for c in range(8):
                corners[inst, c] = [hi[0] if c & 1 else lo[0],
                                    hi[1] if c & 2 else lo[1],
                                    hi[2] if c & 4 else lo[2]]
            leaves, todo = [], [root]
            while todo:
                n = todo.pop()
                for kk in range(4):
                    if kind[n, kk] == 1:
                        leaves.append(int(a_col[n, kk]))
                    elif kind[n, kk] == 2:
                        todo.append(int(a_col[n, kk]))
            leaves = np.sort(np.asarray(leaves, np.int64))
            slots[inst] = (leaves[:, None] * L + np.arange(L)).reshape(-1)
    return corners, slots


def tree_depth(kind, a_col) -> int:
    """Nodes on the longest root-to-leaf path of the merged graph (kind-2
    and kind-3 edges; children have larger indices than their parents)."""
    depth = np.ones(kind.shape[0], np.int32)
    for r in range(kind.shape[0] - 1, -1, -1):
        d = 1
        for k in range(4):
            if kind[r, k] >= 2:
                d = max(d, 1 + depth[a_col[r, k]])
        depth[r] = d
    return int(depth[0])


def _assemble(tris, attrs, kind, a_col, b_col, boxes, n_top, top_children,
              num_inst, L, stack, worlds, device, lean) -> SceneWideBVH:
    corners, slots = _derived(kind, a_col, b_col, boxes, n_top, num_inst, L)
    depth = tree_depth(kind, a_col)
    static_cols = np.concatenate([kind, a_col, b_col], axis=1)

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    attrs = dev(attrs)
    sw = SceneWideBVH(
        nodes=None, tris=dev(tris),
        tris4=dev(float4_rows(torch.as_tensor(tris))),
        inv_mats=None, attrs=attrs,
        attrs4=None if lean else attrs4_rows(attrs),
        static_cols=dev(static_cols), mesh_boxes=dev(boxes[n_top:]),
        root_corners=dev(corners),
        inst_slots=tuple(dev(s, torch.int64) for s in slots),
        top_children=tuple(top_children), n_top=int(n_top),
        num_nodes=int(kind.shape[0]), leaf_size=int(L), stack=int(stack),
        k1_stack=3 * depth + 1, depth=depth, lean=bool(lean))
    if worlds is None:
        worlds = torch.eye(4, device=device).expand(num_inst, 4, 4)
    return refit_scene_wide(sw, worlds)


def _mesh_tree(host_mesh, L, builder):
    """A mesh's binary tree: binned SAH on the host (``"sah"``), or the
    Karras LBVH (``"lbvh"``, bvh/lbvh.py, the reference's ``geom.blas``)."""
    if builder == "sah":
        return build_sah(host_mesh["positions"], host_mesh["tri"],
                         chain_cutoff=L)
    if builder == "lbvh":
        bvh = build_lbvh(torch.as_tensor(host_mesh["positions"]),
                         torch.as_tensor(host_mesh["tri"]).reshape(-1))
        return type(bvh)(*(x.numpy() for x in bvh))
    raise ValueError(f"builder must be 'sah' or 'lbvh', got {builder!r}")


def build_scene_wide(geom, mesh_ids, leaf_size: int = 16, worlds=None,
                     device=None, builder: str = "sah", lean: bool = True
                     ) -> SceneWideBVH:
    """geom: trace.geometry.SceneGeometry; mesh_ids: instance -> mesh.
    Host build of all topology and object-space geometry (binned-SAH or
    LBVH subtrees, 4-wide collapse with padded L-slot leaves), then a
    refit at ``worlds`` (identity by default).  lean=False marks the tree
    for K1's fat mode (and gives it ``attrs4``).  Defaults are the
    reference's."""
    L = leaf_size
    num_inst = len(mesh_ids)
    assert num_inst < (1 << 11), "instance tag field is 11 bits"
    mesh_set = sorted(set(mesh_ids))
    host = {m: {k: getattr(geom.meshes[m], k).cpu().numpy()
                for k in ("positions", "normals", "tri", "v0", "e1", "e2")}
            for m in mesh_set}
    mesh_recs = {m: build_records4_padded(_mesh_tree(host[m], L, builder), L)
                 for m in mesh_set}

    top_records = _instance_tree(num_inst)
    n_top = len(top_records)
    node_off, leaf_off = {}, {}
    n_nodes, n_leaves = n_top, 0
    for m in mesh_set:
        recs, stream = mesh_recs[m]
        node_off[m], leaf_off[m] = n_nodes, n_leaves
        n_nodes += len(recs)
        n_leaves += len(stream) // L
    N = n_nodes
    assert N < MAX_NODES

    kind = np.zeros((N, 4), np.int32)
    a_col = np.zeros((N, 4), np.int32)
    b_col = np.zeros((N, 4), np.int32)
    boxes = np.zeros((N, 24), np.float32)
    for k in range(4):                   # empty children never intersect
        boxes[:, k * 6:k * 6 + 3] = BIG
        boxes[:, k * 6 + 3:k * 6 + 6] = -BIG

    top_children = []
    for r, rec in enumerate(top_records):
        childs = []
        for k, c in enumerate(rec):
            if c[0] == "inst":
                i = c[1]
                kind[r, k], a_col[r, k], b_col[r, k] = (
                    3, node_off[mesh_ids[i]], i + 1)
                childs.append((3, i, i + 1))
            else:
                kind[r, k], a_col[r, k] = 2, c[1]
                childs.append((2, c[1], 0))
        top_children.append(tuple(childs))

    for m in mesh_set:
        recs, _ = mesh_recs[m]
        off, loff = node_off[m], leaf_off[m]
        for r, rec in enumerate(recs):
            for k, c in enumerate(rec):
                kind[off + r, k] = c["kind"]
                a_col[off + r, k] = (loff + c["a"] if c["kind"] == 1
                                     else off + c["a"])
                b_col[off + r, k] = c["b"]
                boxes[off + r, k * 6:k * 6 + 3] = c["lo"]
                boxes[off + r, k * 6 + 3:k * 6 + 6] = c["hi"]

    # static stream: (S, 9) geometry + (S, 10) attrs [n0 n1 n2 | prim]
    tris, attrs = [], []
    for m in mesh_set:
        perm = np.asarray(mesh_recs[m][1], np.int64)
        pad = perm < 0
        perm_c = np.clip(perm, 0, None)
        g = host[m]
        v0 = g["v0"][perm_c].astype(np.float32)
        v0[pad] = np.nan                     # pad slots never intersect
        tris.append(np.concatenate([v0, g["e1"][perm_c], g["e2"][perm_c]],
                                   axis=1).astype(np.float32))
        nrm = g["normals"][g["tri"][perm_c]].reshape(-1, 9)
        prim = np.where(pad, 0, perm_c).astype(np.float32)
        attrs.append(np.concatenate([nrm, prim[:, None]], axis=1))

    # stack bound of the reference's two-pop DFS over the merged graph
    # (kind-3 edges jump from top nodes to mesh roots, larger indices)
    stack = max(128, 6 * tree_depth(kind, a_col) + 16)

    return _assemble(np.concatenate(tris), np.concatenate(attrs), kind,
                     a_col, b_col, boxes, n_top, top_children, num_inst, L,
                     stack, worlds, device, lean)


def from_reference_arrays(nodes, tris, inv_mats, attrs, leaf_size, stack,
                          n_top, top_children, device=None) -> SceneWideBVH:
    """The port's structure from the reference SceneWideBVH's arrays as
    numpy: nodes (Nt, 36, 128), tris (Lt, 9L, 128), inv_mats (1+I, 12),
    attrs (S, >=10); or, for a tree the reference built with lean=False,
    attrs None and tris (Lt, 19L, 128) fat columns [geometry 9L | object
    normals 9L | prim L], whose normals and prim become the attrs rows
    and which is marked lean=False.  The BVH is carried across unchanged, so both sides trace the
    identical tree."""
    L = int(leaf_size)
    rows = np.array(nodes, np.float32).transpose(0, 2, 1).reshape(-1, 36)
    cols = np.array(tris, np.float32)
    cols = cols.transpose(0, 2, 1).reshape(-1, cols.shape[1])
    inv_mats = np.array(inv_mats, np.float32)
    num_inst = inv_mats.shape[0] - 1
    kind = rows[:, 24:28].astype(np.int32)
    a_col = rows[:, 28:32].astype(np.int32)
    b_col = rows[:, 32:36].astype(np.int32)
    lean = attrs is not None
    if lean:
        attrs = np.asarray(attrs, np.float32)[:, :10]
        slots = cols.reshape(-1, 9)[:attrs.shape[0]]
    else:                      # every leaf ordinal is one kind-1 child
        n_leaves = int((kind == 1).sum())
        cols = cols[:n_leaves]
        slots = cols[:, :9 * L].reshape(-1, 9)
        attrs = np.concatenate([cols[:, 9 * L:18 * L].reshape(-1, 9),
                                cols[:, 18 * L:].reshape(-1, 1)], axis=1)
    sw = _assemble(slots, attrs, kind, a_col, b_col, rows[:, :24], n_top,
                   top_children, num_inst, L, stack, None, device, lean)
    return sw._replace(nodes=torch.as_tensor(rows, device=device),
                       inv_mats=torch.as_tensor(inv_mats, device=device))


def inverse_rows(worlds):
    """The (1 + I, 12) inverse-world table of (I, 4, 4) row-vector worlds:
    row 0 the identity (tag 0 = world space), then each instance's 3x3
    inverse row-major and its translation."""
    num_inst = worlds.shape[0]
    inv3 = torch.linalg.inv_ex(worlds[:, :3, :3]).inverse  # no host sync
    t_inv = -torch.einsum("ic,icd->id", worlds[:, 3, :3], inv3)
    ident = torch.cat([torch.eye(3, device=worlds.device).reshape(9),
                       worlds.new_zeros(3)])[None]
    return torch.cat([ident, torch.cat([inv3.reshape(num_inst, 9),
                                        t_inv], dim=1)]).contiguous()


def refit_scene_wide(sw: SceneWideBVH, worlds, inv_mats=None
                     ) -> SceneWideBVH:
    """Per-frame refit: instance world boxes from the 8 transformed root
    corners, top-tree unions bottom-up, inverse-world table.  The
    object-space streams are static (RayTracer.cpp:326-341).  inv_mats:
    the worlds' ``inverse_rows`` where the caller has them (the renderer
    computes them on the host with its other frame constants), else
    computed here."""
    wc = (torch.einsum("icd,ide->ice", sw.root_corners, worlds[:, :3, :3])
          + worlds[:, None, 3, :3])
    inst_lo, inst_hi = wc.amin(dim=1), wc.amax(dim=1)

    big = worlds.new_full((3,), BIG)
    node_lo, node_hi, rows = {}, {}, {}
    for r in range(sw.n_top - 1, -1, -1):
        lows, highs = [], []
        for (knd, a, _b) in sw.top_children[r]:
            lows.append(inst_lo[a] if knd == 3 else node_lo[a])
            highs.append(inst_hi[a] if knd == 3 else node_hi[a])
        node_lo[r] = torch.stack(lows).amin(dim=0)
        node_hi[r] = torch.stack(highs).amax(dim=0)
        lows += [big] * (4 - len(lows))
        highs += [-big] * (4 - len(highs))
        rows[r] = torch.cat([torch.stack(lows), torch.stack(highs)],
                            dim=1).reshape(24)
    top_boxes = torch.stack([rows[r] for r in range(sw.n_top)])
    boxes = torch.cat([top_boxes, sw.mesh_boxes])
    nodes = torch.cat([boxes, sw.static_cols], dim=1).contiguous()
    if inv_mats is None:
        inv_mats = inverse_rows(worlds)
    return sw._replace(nodes=nodes, inv_mats=inv_mats)


def trace_scene_wide_fused(sw: SceneWideBVH, ray_o, ray_d, t_min, t_max,
                           slim: bool = False, stats=None):
    """Closest hit for WORLD-space rays across all instances in one K1
    launch (its plain version for CPU tensors).  Returns (HitRecord,
    normal): normal is the unnormalised OBJECT-space interpolated vertex
    normal (zero where missed).

    Lean (the default): one gather of the static attrs rows resolves the
    winner's normals and prim.  slim=True launches K1s, which returns only
    (t, slot, inst), then K1e (``slim_uv``), which recomputes the winner's
    u, v with one Moller-Trumbore in its instance's object space, from its
    slot row and its inverse world taken by index (the reference's
    one-hot matmul), in the walk's own arithmetic, so the slim frame's u,
    v equal the lean frame's.  A tree built with lean=False launches K1f,
    which interpolates the normal and takes prim itself; slim needs the
    lean tree.

    stats: an optional (2,) or (n, 2) int64 tensor to which K1, in every
    mode, adds its child-box tests and triangle tests, or a (3,) or
    (n, 3) one for its instance entries besides
    (``trace_tiles_instanced``; ``engine.spans``); the plain version on
    CPU tensors leaves it untouched."""
    o, d = ray_o.contiguous(), ray_d.contiguous()
    args = (sw.nodes, sw.tris4, sw.inv_mats, sw.inst_slots, o, d, t_min,
            t_max, sw.leaf_size, sw.k1_stack, stats)
    if not sw.lean:
        if slim:
            raise ValueError("slim requires a lean tree")
        t, u, v, nrm, prim, inst = trace_tiles_instanced(
            *args, lean=False, attrs4=sw.attrs4)
    elif slim:
        t, slot, inst = trace_tiles_instanced(*args, slim=True)
        u, v = slim_uv(sw.tris4, sw.inv_mats, o, d, slot, inst)
        nrm, prim = slot_normals(sw.attrs, slot, u, v)
    else:
        t, u, v, slot, inst = trace_tiles_instanced(*args)
        nrm, prim = slot_normals(sw.attrs, slot, u, v)
    rec = HitRecord(t=t, prim=prim.to(torch.int64), u=u, v=v, hit=prim >= 0,
                    inst=inst.to(torch.int64))
    return rec, nrm
