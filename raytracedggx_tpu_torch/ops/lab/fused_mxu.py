"""Instanced traversal with the leaf test as a linear form: K7 and its
plain twin.

Torch/CUDA port of raytracedggx_tpu/ops/lab/fused_mxu.py.  Moller-
Trumbore's det, u*det, v*det and t*det are linear in the per-ray features
F = [o, d, o x d, 1] (det = d.(e2 x e1), u*det = c.e2 - d.(e2 x v0),
v*det = -c.e1 + d.(e1 x v0), t*det = o.n - v0.n with n = e1 x e2), so a
leaf of L slots becomes one coefficient block and its test one product.
The TPU kernel ``_mxu_kernel`` ran that product on its matrix unit over a
1024-ray packet; here it becomes the CUDA kernel K7 in
``csrc/traverse_mxu.cu`` (one ray per thread, fp32 FMAs), launched by
``trace_tiles_mxu``, which reads the table as per-slot records
(``mxu_records``: a slot's 40 coefficients in 160 contiguous bytes).
``trace_mxu_plain`` is the plain torch version: the same linear form over
every (instance, slot) pair, as one product per instance.

The reference's verdict on the TPU (a loss to the lean L16 kernel,
fused_mxu.py:36-45) is a TPU result and says nothing about this card.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..cuda_lib import check_launch, load_library, pointer, require, \
    stream_handle
from ..traverse_cuda import per_ray
from .fused_lab import THREADS_PER_ROW, check_smem, pre_ray_state


def mxu_stream(sw):
    """(n_leaves, 10, 4L) f32 leaf coefficients from the scene's (S, 9)
    slots, with the reference's numpy arithmetic (bit for bit): feature
    rows [o, d, o x d, 1], output columns [det x L | u x L | v x L |
    t x L].  Pad slots have v0 = NaN, so their u, v and t columns are NaN
    and never hit.  Needs 4 * leaf_size <= 128."""
    L = int(sw.leaf_size)
    assert 4 * L <= 128, "coefficient block needs 4L lanes <= 128"
    g = sw.tris.cpu().numpy().reshape(-1, L, 9)
    v0, e1, e2 = g[..., 0:3], g[..., 3:6], g[..., 6:9]
    n = np.cross(e1, e2)
    C = np.zeros((g.shape[0], 10, 4 * L), np.float32)

    def put(rows, grp, val):               # val: (NL, L, 3) | (NL, L)
        if val.ndim == 3:
            C[:, rows:rows + 3, grp * L:(grp + 1) * L] = \
                val.transpose(0, 2, 1)
        else:
            C[:, rows, grp * L:(grp + 1) * L] = val

    put(3, 0, np.cross(e2, e1))            # det  <- d
    put(6, 1, e2)                          # u    <- c
    put(3, 1, -np.cross(e2, v0))           # u    <- d
    put(6, 2, -e1)                         # v    <- c
    put(3, 2, np.cross(e1, v0))            # v    <- d
    put(0, 3, n)                           # t    <- o
    put(9, 3, -(v0 * n).sum(-1))           # t    <- 1
    return torch.as_tensor(C, device=sw.tris.device)


def mxu_records(coef):
    """(n_leaves * L, 40) f32 per-slot records of a (n_leaves, 10, 4L)
    table: slot leaf * L + k holds, for each feature f in turn, the
    coefficients of its det, u*det, v*det and t*det (one float4), each
    equal to its entry of ``coef``."""
    n_leaves, _, w = coef.shape
    L = w // 4
    return (coef.reshape(n_leaves, 10, 4, L).permute(0, 3, 1, 2)
            .reshape(n_leaves * L, 40).contiguous())


# id(table) -> (table's version, its records); an entry goes with its table
_RECORDS: dict = {}


def _records_of(coef):
    """``mxu_records(coef)``, built once per table (again if the table was
    written to since)."""
    key = id(coef)
    hit = _RECORDS.get(key)
    if hit is None or hit[0] != coef._version:
        if hit is None:
            weakref.finalize(coef, _RECORDS.pop, key, None)
        hit = _RECORDS[key] = (coef._version, mxu_records(coef))
    return hit[1]


def features(rs):
    """(R, 10) [o, d, o x d, 1] of object rays rs (R, >= 6), the cross
    product in the kernel's order."""
    ox, oy, oz, dx, dy, dz = rs[:, :6].unbind(-1)
    return torch.stack([ox, oy, oz, dx, dy, dz, oy * dz - oz * dy,
                        oz * dx - ox * dz, ox * dy - oy * dx,
                        torch.ones_like(ox)], dim=-1)


def trace_mxu_plain(coef, inv_mats, inst_slots, ray_o, ray_d, t_min, t_max,
                    leaf_size: int):
    """Plain K7: the linear-form leaf test over every (instance, stream
    slot) pair, an (R, 10) by (10, 4 S_i) product per instance, chunked
    over rays; ties go to the lowest (inst, slot).  Returns (t, u, v,
    slot, inst) as K7."""
    dev = ray_o.device
    R, L = ray_o.shape[0], int(leaf_size)
    t_max = per_ray(t_max, ray_o)
    state = pre_ray_state(inv_mats, ray_o, ray_d)
    best_t = t_max.clone()
    best_u = torch.zeros(R, device=dev)
    best_v = torch.zeros(R, device=dev)
    best_slot = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_inst = torch.full((R,), -1, dtype=torch.int32, device=dev)
    for i, slots in enumerate(inst_slots):
        F = features(state[i + 1])
        leaf, k = slots // L, slots % L
        # (10, 4, S_i): the det, u, v and t columns of every slot
        W = torch.stack([coef[leaf, :, g * L + k] for g in range(4)],
                        dim=-1).permute(1, 2, 0)
        n_s = slots.shape[0]
        lane = torch.arange(n_s, device=dev)
        chunk = max(1, (1 << 22) // max(4 * n_s, 1))
        for r0 in range(0, R, chunk):
            sl = slice(r0, min(R, r0 + chunk))
            out = (F[sl] @ W.reshape(10, 4 * n_s)).reshape(-1, 4, n_s)
            rcp = 1.0 / out[:, 0]
            u, v, t = out[:, 1] * rcp, out[:, 2] * rcp, out[:, 3] * rcp
            ok = ((u >= 0) & (v >= 0) & (u + v <= 1) & (t >= t_min)
                  & (t <= t_max[sl, None]))
            tt = torch.where(ok, t, torch.inf)
            tb = tt.amin(dim=1)
            j = torch.where(ok & (tt == tb[:, None]), lane, n_s).amin(dim=1)
            jc = torch.clamp(j, max=n_s - 1)[:, None]
            upd = (j < n_s) & ((best_slot[sl] < 0) | (tb < best_t[sl]))
            best_t[sl] = torch.where(upd, tb, best_t[sl])
            best_u[sl] = torch.where(upd, u.gather(1, jc)[:, 0], best_u[sl])
            best_v[sl] = torch.where(upd, v.gather(1, jc)[:, 0], best_v[sl])
            best_slot[sl] = torch.where(upd, slots[jc[:, 0]].to(torch.int32),
                                        best_slot[sl])
            best_inst[sl] = torch.where(upd, i, best_inst[sl])
    return best_t, best_u, best_v, best_slot, best_inst


def trace_tiles_mxu(nodes, coef, inv_mats, inst_slots, ray_o, ray_d, t_min,
                    t_max, leaf_size: int, stack: int = 128,
                    tile_s: int = 8, totals=None):
    """K7 wrapper, the contract of trace_tiles_instanced: (t, u, v, slot,
    inst) of (R, 3) WORLD-space rays, slot = leaf * L + k (-1 on a miss).
    ``coef`` from ``mxu_stream`` (the kernel reads ``mxu_records`` of it,
    built on the first launch with the table); ``stack``: the shared-memory
    stack per ray, ``stack_bound(sw.depth, 2)``, which 16 * tile_s threads
    must fit in a block's shared memory or this raises; ``totals``:
    optional (2,) int64 tensor the kernel adds its box tests and slot tests
    to.  CUDA tensors launch the kernel (or raise); CPU tensors take
    ``trace_mxu_plain``."""
    L = int(leaf_size)
    threads = THREADS_PER_ROW * int(tile_s)
    if not 1 <= threads <= 512:
        raise ValueError(f"tile_s {tile_s}: 16 * tile_s threads per block "
                         "must be 1..512")
    if 4 * L > 128:
        raise ValueError("coefficient block needs 4L lanes <= 128")
    check_smem("K7", threads, stack)
    t_max = per_ray(t_max, ray_o)
    if ray_o.device.type == "cpu":
        return trace_mxu_plain(coef, inv_mats, inst_slots, ray_o, ray_d,
                               t_min, t_max, L)
    dev, f32 = ray_o.device, torch.float32
    R = ray_o.shape[0]
    require("nodes", nodes, (None, 36), f32, dev)
    require("coef", coef, (None, 10, 4 * L), f32, dev)
    require("inv_mats", inv_mats, (None, 12), f32, dev)
    require("ray_o", ray_o, (R, 3), f32, dev)
    require("ray_d", ray_d, (R, 3), f32, dev)
    if totals is not None:
        require("totals", totals, (2,), torch.int64, dev)
    if nodes.data_ptr() % 16:
        raise ValueError("nodes: K7 reads float4 rows, need a 16-byte "
                         "aligned tensor")
    rec = _records_of(coef)
    lib = load_library()
    t, u, v = (torch.empty(R, dtype=f32, device=dev) for _ in range(3))
    slot, inst = (torch.empty(R, dtype=torch.int32, device=dev)
                  for _ in range(2))
    err = lib.rtggx_trace_mxu(
        nodes.data_ptr(), rec.data_ptr(), inv_mats.data_ptr(),
        ray_o.data_ptr(), ray_d.data_ptr(), t_max.data_ptr(), float(t_min),
        R, L, int(stack), threads, t.data_ptr(), u.data_ptr(), v.data_ptr(),
        slot.data_ptr(), inst.data_ptr(), pointer(totals),
        stream_handle(dev))
    check_launch(err, "K7 trace_tiles_mxu")
    trace_tiles_mxu.launches += 1
    return t, u, v, slot, inst


trace_tiles_mxu.launches = 0
