"""Instanced closest-hit traversal: kernel K1 and its plain twin.

Torch/CUDA port of raytracedggx_tpu/ops/fused.py.  The host function
``build_records4_padded`` is copied unchanged (numpy).  The TPU kernel
``_instanced_kernel`` becomes the CUDA kernel in ``csrc/traverse.cu``,
launched by ``trace_tiles_instanced``: one ray per thread with its own
stack, in place of 1024-ray packets sharing one SMEM stack.
``trace_instanced_plain`` is the plain torch version of the same
contract — brute-force Moller-Trumbore over every (instance, stream slot)
pair — used for tensors on the CPU and as the kernel's oracle.

Layout (see ops/scene_wide.py): nodes (N, 36) f32 rows, tris (S, 9) f32
stream slots (leaf j = slots [j*L, (j+1)*L), padding v0 = NaN),
inv_mats (1 + I, 12) inverse worlds with row 0 the identity.  The kernel
reads node rows as nine float4 and the slots from their (S, 12) copy
``SceneWideBVH.tris4`` (v0, e1, e2 each padded to a float4).

Three output modes, the TPU kernel's, one template instance each:
- lean (K1): (t, u, v, slot, inst); t is t_max and u, v are 0 on a miss;
  slot = leaf*L + k and inst are int32, -1 on a miss;
- slim (K1s, ``slim=True``): (t, slot, inst); ``slim_uv`` (kernel K1e)
  recomputes the winner's u, v from its slot and inst with the walk's own
  arithmetic (ops/scene_wide.trace_scene_wide_fused);
- fat (K1f, ``lean=False``): (t, u, v, normal (R, 3), prim, inst), the
  unnormalised OBJECT-space normal interpolated from the winner's
  ``attrs4`` row (``slot_normals``' arithmetic), zero and -1 on a miss.
"""

from __future__ import annotations

import numpy as np
import torch

from ..trace.traverse import per_ray
from .cuda_lib import (check_launch, load_library, pointer, require,
                       stream_handle)
from .flatten import float3_rows


def build_records4_padded(bvh, leaf_size: int = 8, compact: bool = True):
    """Collapse a binary LBVH into 4-wide supernodes with every leaf
    padded to exactly `leaf_size` stream slots (pad slot = -1).  Returns
    (records, tri_stream): records[i] = child dicts {kind, a, b} where a
    is a LEAF ORDINAL for kind=1 (not a stream position) and a supernode
    index for kind=2; b = real triangle count.  Leaf ordinal j covers
    stream slots [j*L, (j+1)*L).  Mirrors ops/wide.build_records4 but
    with the fixed-size-leaf invariant the fused kernel needs.

    compact=True is the TPU analog of the reference's acceleration-
    structure compaction flow (build -> COMPACTED_SIZE query -> pack ->
    copy, RayTracer.cpp:163-212 / XUSGRayTracing.h:51-66): sibling leaf
    children whose triangle counts bin-pack into one leaf_size slot are
    merged (box = union), shrinking the padded stream and the per-tile
    leaf-visit count.  compaction_stats() is the size-query analog."""
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    amin = np.asarray(bvh.aabb_min)
    amax = np.asarray(bvh.aabb_max)
    leaf_tri = np.asarray(bvh.leaf_tri)
    n = len(leaf_tri)
    n_int = n - 1
    L = leaf_size

    counts = np.ones(2 * n - 1, np.int64)
    for _ in range(4096):      # fixed point after `depth` rounds
        new = counts[left] + counts[right]
        if np.array_equal(new, counts[:n_int]):
            break
        counts[:n_int] = new
    else:
        raise ValueError("BVH deeper than 4096 — malformed tree?")

    def leaves_of(node):
        out = []
        stack = [node]
        while stack:
            v = stack.pop()
            if v >= n_int:
                out.append(leaf_tri[v - n_int])
            else:
                stack.append(right[v])
                stack.append(left[v])
        return out

    def expand4(node):
        kids = [left[node], right[node]]
        while len(kids) < 4:
            best, best_c = -1, L
            for i, k in enumerate(kids):
                if k < n_int and counts[k] > best_c:
                    best, best_c = i, counts[k]
            if best < 0:
                break
            k = kids.pop(best)
            kids[best:best] = [left[k], right[k]]
        return kids

    records = []
    tri_stream = []

    def emit_leaf(tris):
        j = len(tri_stream) // L
        tri_stream.extend(tris)
        tri_stream.extend([-1] * (L - len(tris)))
        return j

    def emit(node):
        idx = len(records)
        records.append(None)
        childs = []
        leafs = []
        for k in expand4(node):
            if k >= n_int or counts[k] <= L:
                leafs.append(k)
            else:
                childs.append(dict(kind=2, a=None, b=0, node=k,
                                   lo=amin[k], hi=amax[k]))
        if compact and len(leafs) > 1:
            # pack -> copy: greedy first-fit-decreasing bin pack of
            # sibling leaves into leaf_size-slot bins
            leafs.sort(key=lambda k: -counts[k] if k < n_int else -1)
            bins = []                 # [(count, [subtree...])]
            for k in leafs:
                c = counts[k] if k < n_int else 1
                for b in bins:
                    if b[0] + c <= L:
                        b[0] += c
                        b[1].append(k)
                        break
                else:
                    bins.append([c, [k]])
            for _cnt, ks in bins:
                tris = [t for k in ks for t in leaves_of(k)]
                lo = np.min([amin[k] for k in ks], axis=0)
                hi = np.max([amax[k] for k in ks], axis=0)
                childs.append(dict(kind=1, a=emit_leaf(tris),
                                   b=len(tris), lo=lo, hi=hi))
        else:
            for k in leafs:
                tris = leaves_of(k)
                childs.append(dict(kind=1, a=emit_leaf(tris),
                                   b=len(tris), lo=amin[k], hi=amax[k]))
        records[idx] = childs
        for c in childs:
            if c["kind"] == 2:
                c["a"] = emit(c["node"])
        return idx

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(10 ** 5)
    try:
        if n == 1 or counts[0] <= L:
            root = 0 if n > 1 else n_int
            tris = leaves_of(root)
            records.append([dict(kind=1, a=emit_leaf(tris), b=len(tris),
                                 lo=amin[root], hi=amax[root])])
        else:
            emit(0)
    finally:
        sys.setrecursionlimit(old)
    return records, tri_stream


def slot_normals(attrs, slot, u, v):
    """(normal (R, 3), prim int32) of each ray's winning stream slot from
    the (S, >= 10) attrs rows n0 n1 n2 | prim: the unnormalised
    w0*n0 + u*n1 + v*n2 with w0 = (1 - u) - v, zero and -1 where slot < 0.
    K1's fat mode rounds the same operations in the same order."""
    hit = slot >= 0
    att = attrs[torch.clamp(slot.to(torch.int64), 0, attrs.shape[0] - 1)]
    w0 = (1.0 - u - v)[..., None]
    nrm = w0 * att[:, 0:3] + u[..., None] * att[:, 3:6] \
        + v[..., None] * att[:, 6:9]
    return (torch.where(hit[..., None], nrm, 0.0),
            torch.where(hit, att[:, 9].to(torch.int32), -1))


def attrs4_rows(attrs):
    """K1f's (S, 12) copy of the (S, 10) attrs rows, attrs | 0 0, so a row
    is three 16-byte loads."""
    return torch.nn.functional.pad(attrs[:, :10], (0, 2)).contiguous()


MODES = {"lean": 0, "slim": 1, "fat": 2}   # csrc/traverse.cu's K1_* modes


def _mode(slim, lean, attrs):
    if slim and not lean:
        raise ValueError("slim requires the lean layout")
    if not lean and attrs is None:
        raise ValueError("the fat mode (lean=False) needs the attrs rows")
    return "slim" if slim else "lean" if lean else "fat"


def trace_instanced_plain(tris, inv_mats, inst_slots, ray_o, ray_d, t_min,
                          t_max, slim=False, lean=True, attrs=None):
    """Plain torch K1: brute-force Moller-Trumbore over every (instance,
    stream slot) pair, chunked over rays.  Same outputs as the kernel in
    each mode (slim: (t, slot, inst); lean=False: (t, u, v, normal, prim,
    inst) from the (S, >= 10) ``attrs``); ties go to the lowest (inst,
    slot).  inst_slots[i]: int64 stream slots of instance i's mesh."""
    mode = _mode(slim, lean, attrs)
    dev = ray_o.device
    R = ray_o.shape[0]
    t_max = per_ray(t_max, ray_o)
    best_t = t_max.clone()
    best_u = torch.zeros(R, device=dev)
    best_v = torch.zeros(R, device=dev)
    best_slot = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_inst = torch.full((R,), -1, dtype=torch.int32, device=dev)
    for i, slots in enumerate(inst_slots):
        m = inv_mats[i + 1]
        # same order of operations as the kernel's object-space transform
        o = (ray_o[:, 0:1] * m[0:3] + ray_o[:, 1:2] * m[3:6]
             + ray_o[:, 2:3] * m[6:9] + m[9:12])
        d = ray_d[:, 0:1] * m[0:3] + ray_d[:, 1:2] * m[3:6] \
            + ray_d[:, 2:3] * m[6:9]
        geo = tris[slots]
        v0, e1, e2 = geo[:, 0:3], geo[:, 3:6], geo[:, 6:9]
        n_s = slots.shape[0]
        lane = torch.arange(n_s, device=dev)
        chunk = max(1, (1 << 22) // max(n_s, 1))
        for r0 in range(0, R, chunk):
            sl = slice(r0, min(R, r0 + chunk))
            oo, dd = o[sl, None, :], d[sl, None, :]
            pv = torch.linalg.cross(dd.expand(-1, n_s, -1),
                                    e2.expand(oo.shape[0], -1, -1))
            inv_det = 1.0 / (e1 * pv).sum(-1)
            tv = oo - v0
            u = (tv * pv).sum(-1) * inv_det
            qv = torch.linalg.cross(tv, e1.expand_as(tv))
            v = (dd * qv).sum(-1) * inv_det
            t = (e2 * qv).sum(-1) * inv_det
            ok = ((u >= 0) & (v >= 0) & (u + v <= 1) & (t >= t_min)
                  & (t <= t_max[sl, None]))
            tt = torch.where(ok, t, float("inf"))
            tb = tt.amin(dim=1)
            k = torch.where(ok & (tt == tb[:, None]), lane, n_s).amin(dim=1)
            found = k < n_s
            kc = torch.clamp(k, max=n_s - 1)[:, None]
            upd = found & ((best_slot[sl] < 0) | (tb < best_t[sl]))
            best_t[sl] = torch.where(upd, tb, best_t[sl])
            best_u[sl] = torch.where(upd, u.gather(1, kc)[:, 0], best_u[sl])
            best_v[sl] = torch.where(upd, v.gather(1, kc)[:, 0], best_v[sl])
            best_slot[sl] = torch.where(upd, slots[kc[:, 0]].to(torch.int32),
                                        best_slot[sl])
            best_inst[sl] = torch.where(upd, i, best_inst[sl])
    if mode == "slim":
        return best_t, best_slot, best_inst
    if mode == "fat":
        return (best_t, best_u, best_v,
                *slot_normals(attrs, best_slot, best_u, best_v), best_inst)
    return best_t, best_u, best_v, best_slot, best_inst


def trace_tiles_instanced(nodes, tris4, inv_mats, inst_slots, ray_o, ray_d,
                          t_min, t_max, leaf_size: int, stack: int,
                          stats=None, slim: bool = False, lean: bool = True,
                          attrs4=None):
    """K1 wrapper: closest hit of (R, 3) WORLD-space rays over the
    instanced scene BVH.  tris4: the (S, 12) slot rows; stack: the tree's
    K1 bound (``SceneWideBVH.k1_stack``), at most the kernel's compiled
    shared-memory stack (``rtggx_k1_max_stack``, 64), else this raises.
    slim=True launches K1s, lean=False K1f, which reads the (S, 12)
    ``attrs4`` rows (``attrs4_rows``; a fat tree's ``SceneWideBVH.attrs4``);
    slim requires lean.  Returns
    the mode's outputs (module docstring).  CUDA tensors launch the kernel
    (or raise); CPU tensors take ``trace_instanced_plain`` on the (S, 9)
    slots, which leaves stats untouched.  stats: optional (2,) or (n, 2)
    int64 tensor the kernel adds its box and triangle tests to, or (3,)
    or (n, 3) for its instance entries besides (``stat_layout``), block b
    to row b % n (n rows spread the warps' atomics; the caller sums
    them).  Launches count per mode: ``launches`` (lean),
    ``launches_slim``, ``launches_fat``.
    Launch counters count calls that launch the kernel: a frame
    captured into a CUDA graph (``Renderer.step_n``) counts once, at
    capture, not at each replay."""
    mode = _mode(slim, lean, attrs4)
    t_max = per_ray(t_max, ray_o)
    if ray_o.device.type == "cpu":
        return trace_instanced_plain(
            float3_rows(tris4), inv_mats, inst_slots, ray_o, ray_d, t_min,
            t_max, slim, lean, None if attrs4 is None else attrs4[:, :10])
    dev, f32, i32 = ray_o.device, torch.float32, torch.int32
    R = ray_o.shape[0]
    require("nodes", nodes, (None, 36), f32, dev)
    require("tris4", tris4, (None, 12), f32, dev)
    require("inv_mats", inv_mats, (None, 12), f32, dev)
    require("ray_o", ray_o, (R, 3), f32, dev)
    require("ray_d", ray_d, (R, 3), f32, dev)
    rows = [("nodes", nodes), ("tris4", tris4), ("inv_mats", inv_mats)]
    if mode == "fat":
        require("attrs4", attrs4, (tris4.shape[0], 12), f32, dev)
        rows.append(("attrs4", attrs4))
    slots, width = 1, 2
    if stats is not None:
        slots, width = stat_layout(stats)
        require("stats", stats, (None,) * stats.dim(), torch.int64, dev)
    for name, t in rows:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: K1 reads float4 rows, need a "
                             f"16-byte aligned tensor")
    lib = load_library()
    if not 1 <= stack <= lib.rtggx_k1_max_stack():
        raise ValueError(f"the tree needs a stack of {stack}; K1 compiles "
                         f"{lib.rtggx_k1_max_stack()}")

    def out(*shape, dtype=f32):
        return torch.empty((R, *shape), dtype=dtype, device=dev)

    out_t, out_id, out_inst = out(), out(dtype=i32), out(dtype=i32)
    out_u = out_v = out_n = None
    if mode != "slim":
        out_u, out_v = out(), out()
    if mode == "fat":
        out_n = out(3)
    err = lib.rtggx_trace_instanced(
        nodes.data_ptr(), tris4.data_ptr(), inv_mats.data_ptr(),
        pointer(attrs4 if mode == "fat" else None), ray_o.data_ptr(),
        ray_d.data_ptr(), t_max.data_ptr(), float(t_min), R, int(leaf_size),
        int(stack), MODES[mode], out_t.data_ptr(), pointer(out_u),
        pointer(out_v), pointer(out_n), out_id.data_ptr(),
        out_inst.data_ptr(), pointer(stats), slots, width,
        stream_handle(dev))
    check_launch(err, f"K1 trace_tiles_instanced ({mode})")
    if mode == "slim":
        trace_tiles_instanced.launches_slim += 1
        return out_t, out_id, out_inst
    if mode == "fat":
        trace_tiles_instanced.launches_fat += 1
        return out_t, out_u, out_v, out_n, out_id, out_inst
    trace_tiles_instanced.launches += 1
    return out_t, out_u, out_v, out_id, out_inst


trace_tiles_instanced.launches = 0
trace_tiles_instanced.launches_slim = 0
trace_tiles_instanced.launches_fat = 0


def stat_layout(stats) -> tuple:
    """(rows, width) of a K1 stats tensor: a (w,) or (n, w) shape, w 2
    (child-box and triangle tests) or 3 (instance entries besides: the
    kind-3 children K1 pushes, each a walk into one instance's
    object-space subtree); else ValueError."""
    shape = tuple(stats.shape)
    if len(shape) not in (1, 2) or shape[-1] not in (2, 3) or 0 in shape:
        raise ValueError(f"stats: need shape (2,), (n, 2), (3,) or (n, 3), "
                         f"got {shape}")
    return (1 if len(shape) == 1 else shape[0]), shape[-1]


def slim_uv_plain(tris, inv_mats, ray_o, ray_d, slot, inst):
    """Plain torch K1e: (u, v) of each ray's winning stream slot from its
    (S, 9) row and its instance's inverse world (row inst + 1, taken by
    index), one Moller-Trumbore in that object space; 0 where slot < 0.
    The reference's recompute after its slim kernel
    (raytracedggx_tpu/ops/scene_wide.py:456-470)."""
    hit = slot >= 0
    geo = tris[torch.clamp(slot.to(torch.int64), 0, tris.shape[0] - 1)]
    m = inv_mats[torch.clamp(inst.to(torch.int64) + 1, 0,
                             inv_mats.shape[0] - 1)]
    o = (ray_o[:, 0:1] * m[:, 0:3] + ray_o[:, 1:2] * m[:, 3:6]
         + ray_o[:, 2:3] * m[:, 6:9] + m[:, 9:12])
    d = (ray_d[:, 0:1] * m[:, 0:3] + ray_d[:, 1:2] * m[:, 3:6]
         + ray_d[:, 2:3] * m[:, 6:9])
    v0, e1, e2 = geo[:, 0:3], geo[:, 3:6], geo[:, 6:9]
    pv = torch.linalg.cross(d, e2)
    inv_det = 1.0 / (e1 * pv).sum(-1)
    tv = o - v0
    u = (tv * pv).sum(-1) * inv_det
    v = (d * torch.linalg.cross(tv, e1)).sum(-1) * inv_det
    return torch.where(hit, u, 0.0), torch.where(hit, v, 0.0)


def slim_uv(tris4, inv_mats, ray_o, ray_d, slot, inst):
    """K1e wrapper, K1s's epilogue: (u, v) of each ray's winning slot
    (K1s's slot and inst), 0 on a miss.  The kernel runs the walk's own
    object-space ray and Moller-Trumbore, so u, v equal lean K1's bit for
    bit; a float32 recompute in another order differs on grazing hits.
    CUDA tensors launch it (or raise); CPU tensors take
    ``slim_uv_plain`` on the (S, 9) slots.
    Launch counters count calls that launch the kernel: a frame
    captured into a CUDA graph (``Renderer.step_n``) counts once, at
    capture, not at each replay."""
    if ray_o.device.type == "cpu":
        return slim_uv_plain(float3_rows(tris4), inv_mats, ray_o, ray_d,
                             slot, inst)
    dev, f32, i32 = ray_o.device, torch.float32, torch.int32
    R = ray_o.shape[0]
    require("tris4", tris4, (None, 12), f32, dev)
    require("inv_mats", inv_mats, (None, 12), f32, dev)
    require("ray_o", ray_o, (R, 3), f32, dev)
    require("ray_d", ray_d, (R, 3), f32, dev)
    require("slot", slot, (R,), i32, dev)
    require("inst", inst, (R,), i32, dev)
    for name, t in (("tris4", tris4), ("inv_mats", inv_mats)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: K1e reads float4 rows, need a "
                             f"16-byte aligned tensor")
    out_u = torch.empty(R, dtype=f32, device=dev)
    out_v = torch.empty(R, dtype=f32, device=dev)
    err = load_library().rtggx_slim_uv(
        tris4.data_ptr(), inv_mats.data_ptr(), ray_o.data_ptr(),
        ray_d.data_ptr(), slot.data_ptr(), inst.data_ptr(), R,
        out_u.data_ptr(), out_v.data_ptr(), stream_handle(dev))
    check_launch(err, "K1e slim_uv")
    slim_uv.launches += 1
    return out_u, out_v


slim_uv.launches = 0
