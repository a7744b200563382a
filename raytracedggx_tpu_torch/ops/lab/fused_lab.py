"""Kernel-lab variants of the instanced traversal: K6a, K6b and their
plain twin.

Torch/CUDA port of raytracedggx_tpu/ops/lab/fused_lab.py.  Each variant
isolates one structural change to K1 (ops/fused.py) so that
``scripts/kbench.py`` can price it.  The TPU kernels ``_lab_kernel`` and
``_ls_kernel`` become the CUDA kernels K6a and K6b in
``csrc/traverse_lab.cu``, launched by ``trace_tiles_lab`` with one ray per
thread; ``trace_lab_plain`` is the plain torch version of both, a
vectorised traversal with one stack per ray that visits nodes and leaves
in the kernels' order, so it returns the same outputs and the same
per-ray counts.  It is used for tensors on the CPU and as the kernels'
oracle.

What the TPU flags become when each thread owns one ray:
  stats       per-ray (R, 2) int32 [node visits, leaf visits] (the TPU
              counted per 1024-ray tile: loop iterations, leaf visits);
  ordered     near-first on the ray's own entry distance (the TPU keyed on
              its tile's mid-ray); False pushes children 0..3 in order;
  npop        1, 2 or 4 entries popped per step, children pushed in the
              TPU kernel's order;
  lean / fat  both read the same slots; prim comes from ``attrs[:, 9]``;
              fat interpolates the winner's normal from ``attrs`` after
              the walk, lean returns a zero normal;
  slim        u = v = 0 returned; noinst: inst = 0 on a hit;
  recip       rcp.approx plus one Newton step in place of the divide;
  fold        each ray picks near and far planes by its own direction
              signs (no per-tile table);
  pre         ``pre_ray_state`` before the launch: a (tags, R, 9) table the
              kernel reads on a tag switch.  It costs tags x 36 bytes per
              ray (3 tags x 921,600 rays: about 100 MB at 1280x720);
  sub         the leaf's ``sub_tris`` boxes gate its chunks of L/sub slots;
              prim is then the stream slot;
  smem_nodes  the first rows of the node table staged in shared memory per
              block (``SMEM_ROWS``: 256 rows, 36,864 bytes);
  tile_s      16 * tile_s threads per block (tile_s = 8: K1's 128);
  stack       each ray's stack capacity, in shared memory beside the
              staged rows: ``stack_bound`` of the tree's depth and npop
              (K6a) or ``ls_stack_bound`` of the depth (K6b) is the most
              the walk can need, and the wrapper raises when 16 * tile_s
              * stack * 4 bytes and the rows exceed a block's shared
              memory.
The plain version ignores recip, fold, pre, smem_nodes and tile_s, which
change no output beyond rounding.  The kernels read the slots as the
(S, 12) ``SceneWideBVH.tris4`` rows; the plain version takes the (S, 9)
slots.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..cuda_lib import (check_launch, load_library, pointer, require,
                        stream_handle)
from ..flatten import float3_rows
from ..traverse_cuda import per_ray

TAG_SHIFT = 20
NODE_MASK = 0xFFFFF
LEAF_BIT = 1 << 30          # K6b stack entry: [30] leaf [29:20] tag [19:0]
THREADS_PER_ROW = 16        # threads per block = 16 * tile_s
EPS = 1e-20
# uniform flags of rtggx_trace_lab (csrc/traverse_lab.cu: LabFlag)
FLAG_BITS = dict(ordered=1, fold=2, pre=4, slim=8, noinst=16, recip=32,
                 fat=64, leaf_stack=128)
EXCHANGES = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))
SMEM_ROWS = 256             # node rows staged per block by smem_nodes
ROW_BYTES = 36 * 4
# dynamic shared memory one block may opt in to on the H100 (227 KB)
SMEM_OPTIN = 232448


def stack_bound(depth: int, npop: int) -> int:
    """The most entries the lab's walk (K6a at ``npop``, K7 at 2) can hold
    on a tree of ``depth`` levels (``SceneWideBVH.depth``): npop * (3 *
    depth - 2), derived in csrc/lab.cuh."""
    return max(1, int(npop) * (3 * int(depth) - 2))


def ls_stack_bound(depth: int) -> int:
    """The most entries K6b's walk (leaves on the stack, two pops per
    step) can hold on a tree of ``depth`` levels (``SceneWideBVH.depth``):
    6 * depth - 2, derived in csrc/lab.cuh."""
    return max(1, 6 * int(depth) - 2)


def check_smem(kernel, threads, stack, rows=0):
    """Raise unless a stack of ``stack`` 4-byte entries (at least one) for
    each of ``threads`` threads and ``rows`` staged node rows fit a block's
    shared memory."""
    need = threads * int(stack) * 4 + rows * ROW_BYTES
    if stack < 1 or need > SMEM_OPTIN:
        raise ValueError(f"{kernel}: a stack of {stack} for {threads} "
                         f"threads and {rows} staged rows needs {need} "
                         f"bytes of shared memory; a block has "
                         f"{SMEM_OPTIN}")


def nodes_flat_for_smem(sw):
    """The node table for ``smem_nodes``: the port's (N, 36) rows already
    are the reference's flat host-order table."""
    return sw.nodes


def lean_tris(sw):
    """The lean leaf stream: the (S, 9) slot geometry (prim is
    ``sw.attrs[:, 9]``)."""
    return sw.tris


def sub_tris(sw, nq: int = 4):
    """(n_leaves, 6 * nq) f32 sub-boxes for the ``sub`` variant: box q of
    a leaf bounds its slots [q*L/nq, (q+1)*L/nq) as lo.xyz, hi.xyz.  Pad
    slots carry NaN vertices, so an all-pad chunk gets a NaN box, which
    fails every slab comparison as pad triangles fail Moller-Trumbore."""
    L = int(sw.leaf_size)
    g = sw.tris.cpu().numpy().reshape(-1, L, 9)
    v0 = g[..., 0:3]
    verts = np.stack([v0, v0 + g[..., 3:6], v0 + g[..., 6:9]], axis=2)
    vq = verts.reshape(g.shape[0], nq, (L // nq) * 3, 3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # all-NaN chunks
        lo = np.nanmin(vq, axis=2)
        hi = np.nanmax(vq, axis=2)
    boxes = np.concatenate([lo, hi], axis=2).reshape(g.shape[0], 6 * nq)
    return torch.as_tensor(boxes.astype(np.float32), device=sw.tris.device)


def safe_inv(d):
    """1/d with |d| raised to at least 1e-20, keeping its sign."""
    return 1.0 / torch.where(d.abs() < EPS,
                             torch.where(d >= 0, EPS, -EPS).to(d.dtype), d)


def pre_ray_state(inv_mats, ray_o, ray_d):
    """(tags, R, 9) f32 [o*M + t | d*M | safe_inv(d*M)]: every ray in every
    tag's object space, with the kernels' order of operations."""
    m = inv_mats.reshape(-1, 1, 4, 3)
    o, d = ray_o[None], ray_d[None]
    oo = (o[..., 0:1] * m[:, :, 0] + o[..., 1:2] * m[:, :, 1]
          + o[..., 2:3] * m[:, :, 2] + m[:, :, 3])
    dd = (d[..., 0:1] * m[:, :, 0] + d[..., 1:2] * m[:, :, 1]
          + d[..., 2:3] * m[:, :, 2])
    return torch.cat([oo, dd, safe_inv(dd)], dim=-1).contiguous()


def _slab(boxes, rs):
    """Entry and exit distances (tn, tf) of boxes (n, k, 6) for object
    rays rs (n, 9)."""
    o, inv = rs[:, None, 0:3], rs[:, None, 6:9]
    t0 = (boxes[..., 0:3] - o) * inv
    t1 = (boxes[..., 3:6] - o) * inv
    return torch.minimum(t0, t1).amax(-1), torch.maximum(t0, t1).amin(-1)


def _moller_trumbore(g, rs, t_min, bt):
    """(ok, t, u, v) of rays rs (n, 9) against slots g (n, L, 9), in the
    kernels' order of operations; ok also needs t <= bt (n,)."""
    ox, oy, oz, dx, dy, dz = (rs[:, None, i] for i in range(6))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = g.unbind(-1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    inv_det = 1.0 / (e1x * px + e1y * py + e1z * pz)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((u >= 0) & (v >= 0) & (u + v <= 1) & (t >= t_min)
          & (t <= bt[:, None]))
    return ok, t, u, v


def _sorted_items(ent, push, tn, ordered):
    """The 4 children of each row as (entry, push) pairs in push order:
    through the 5-exchange network on tn (not-pushed children keyed
    -inf) when ordered, else 0..3."""
    if not ordered:
        return [(ent[:, k], push[:, k]) for k in range(4)]
    key = torch.where(push, tn, -torch.inf)
    items = [[key[:, k], ent[:, k], push[:, k]] for k in range(4)]
    for i, j in EXCHANGES:
        swap = items[i][0] < items[j][0]
        for f in range(3):
            a, b = items[i][f], items[j][f]
            items[i][f] = torch.where(swap, b, a)
            items[j][f] = torch.where(swap, a, b)
    return [(e, p) for _, e, p in items]


def trace_lab_plain(nodes, tris, attrs, inv_mats, ray_o, ray_d, t_min,
                    t_max, leaf_size: int, stack: int = 128, npop: int = 2,
                    ordered: bool = True, lean: bool = False,
                    leaf_stack: bool = False, slim: bool = False,
                    sub: int = 0, boxes=None, noinst: bool = False):
    """Plain K6a (K6b with ``leaf_stack``): the kernels' traversal, one
    stack per ray as an (R, stack) tensor, looping until every stack is
    empty.  Returns (t, u, v, nrm, prim, inst, counts) with counts (R, 3)
    int32: node visits, leaf visits and the deepest the ray's stack got
    (a push onto a full stack is dropped, as in the kernels)."""
    dev = ray_o.device
    R, L = ray_o.shape[0], int(leaf_size)
    t_max = per_ray(t_max, ray_o)
    state = pre_ray_state(inv_mats, ray_o, ray_d)
    best_t = t_max.clone()
    best_u = torch.zeros(R, device=dev)
    best_v = torch.zeros(R, device=dev)
    best_slot = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_inst = torch.full((R,), -1, dtype=torch.int64, device=dev)
    counts = torch.zeros((R, 3), dtype=torch.int64, device=dev)
    stk = torch.zeros((R, stack), dtype=torch.int64, device=dev)
    sp = (t_max >= 0).to(torch.int64)      # live rays hold the root, tag 0
    counts[:, 2] = sp
    lane = torch.arange(L, device=dev)

    def leaf(rays, lf, tag, rs):
        bt = best_t[rays]
        slots = lf[:, None] * L + lane
        ok, t, u, v = _moller_trumbore(tris[slots], rs, t_min, bt)
        if sub:
            tn, tf = _slab(boxes[lf].reshape(-1, sub, 6), rs)
            chunk = (tn <= tf) & (tf >= t_min) & (tn <= bt[:, None])
            ok = ok & chunk.repeat_interleave(L // sub, dim=1)
        tt = torch.where(ok, t, torch.inf)
        m = tt.amin(dim=1)
        # the kernels accept t <= best_t in slot order: the last slot at
        # the least t wins
        j = torch.where(ok & (tt == m[:, None]), lane, -1).amax(dim=1)
        f = torch.nonzero(j >= 0)[:, 0]
        jf, r = j[f], rays[f]
        best_t[r] = m[f]
        best_u[r] = u[f, jf]
        best_v[r] = v[f, jf]
        best_slot[r] = slots[f, jf]
        best_inst[r] = tag[f] - 1

    def visit(act, e, has):
        if leaf_stack:
            is_leaf = (e & LEAF_BIT) != 0
            tag = (e >> TAG_SHIFT) & 0x3FF
        else:
            is_leaf = torch.zeros_like(has)
            tag = e >> TAG_SHIFT
        idx = e & NODE_MASK
        rs = state[tag, act]
        lm = has & is_leaf
        if bool(lm.any()):
            counts[act[lm], 1] += 1
            leaf(act[lm], idx[lm], tag[lm], rs[lm])
        node = has & ~is_leaf
        counts[act, 0] += node
        row = nodes[torch.where(node, idx, 0)]
        kind = row[:, 24:28].to(torch.int64)
        child = row[:, 28:32].to(torch.int64)
        tn, tf = _slab(row[:, :24].reshape(-1, 4, 6), rs)
        hit = ((tn <= tf) & (tf >= t_min) & (tn <= best_t[act][:, None])
               & (kind != 0) & node[:, None])
        if not leaf_stack:
            for k in range(4):
                lk = hit[:, k] & (kind[:, k] == 1)
                if bool(lk.any()):
                    counts[act[lk], 1] += 1
                    leaf(act[lk], child[lk, k], tag[lk], rs[lk])
        child_tag = torch.where(kind == 3, row[:, 32:36].to(torch.int64),
                                tag[:, None])
        ent = child | (child_tag << TAG_SHIFT)
        if leaf_stack:
            ent = ent | torch.where(kind == 1, LEAF_BIT, 0)
        push = hit & (kind >= (1 if leaf_stack else 2))
        return _sorted_items(ent, push, tn, ordered)

    n_pop = 2 if leaf_stack else int(npop)
    while True:
        act = torch.nonzero(sp > 0)[:, 0]
        if act.numel() == 0:
            break
        top = sp[act]
        items = []
        for p in range(n_pop):
            e = stk[act, (top - 1 - p).clamp(min=0)]
            items = visit(act, e, top >= p + 1) + items
        a_sp = (top - n_pop).clamp(min=0)
        for ent, push in items:
            ok = push & (a_sp < stack)
            stk[act[ok], a_sp[ok]] = ent[ok]
            a_sp = a_sp + ok
        sp[act] = a_sp
        counts[act, 2] = torch.maximum(counts[act, 2], a_sp)

    hit = best_slot >= 0
    att = attrs[best_slot.clamp(min=0)]
    if sub:
        prim = torch.where(hit, best_slot, -1)
    else:
        prim = torch.where(hit, att[:, 9].to(torch.int64), -1)
    if lean:
        nrm = torch.zeros((R, 3), device=dev)
    else:
        w0 = (1.0 - best_u - best_v)[:, None]
        nrm = (w0 * att[:, 0:3] + best_u[:, None] * att[:, 3:6]
               + best_v[:, None] * att[:, 6:9])
        nrm = torch.where(hit[:, None], nrm, 0.0)
    slim = slim and not leaf_stack          # the TPU's _ls_kernel has
    noinst = noinst and not leaf_stack      # neither mode
    u = torch.zeros_like(best_u) if slim else best_u
    v = torch.zeros_like(best_v) if slim else best_v
    inst = torch.where(hit, 0 if noinst else best_inst, -1)
    return (best_t, u, v, nrm, prim.to(torch.int32), inst.to(torch.int32),
            counts.to(torch.int32))


def lab_kernel(args, stream):
    """Launch K6a with the C arguments of ``rtggx_trace_lab``."""
    check_launch(load_library().rtggx_trace_lab(*args, stream),
                 "K6a trace_tiles_lab")
    lab_kernel.launches += 1


def ls_kernel(args, stream):
    """Launch K6b (``leaf_stack``) with the C arguments of
    ``rtggx_trace_lab``."""
    check_launch(load_library().rtggx_trace_lab(*args, stream),
                 "K6b trace_tiles_lab(leaf_stack=True)")
    ls_kernel.launches += 1


lab_kernel.launches = 0
ls_kernel.launches = 0


def trace_tiles_lab(nodes, tris4, inv_mats, ray_o, ray_d, t_min, t_max,
                    leaf_size: int, stack: int = 128, tile_s: int = 8,
                    stats: bool = False, smem_nodes: bool = False,
                    npop: int = 2, ordered: bool = True, lean: bool = False,
                    leaf_stack: bool = False, recip: bool = False,
                    fold: bool = False, slim: bool = False,
                    pre: bool = False, sub: int = 0, noinst: bool = False,
                    *, attrs, boxes=None, totals=None):
    """Lab launcher mirroring ops/fused.trace_tiles_instanced: closest hit
    of (R, 3) WORLD-space rays through K6a, or K6b with ``leaf_stack``.
    ``tris4``: the scene's (S, 12) slot rows; ``attrs``: its (S, 10) slot
    table; ``stack``: K6a's ``stack_bound(sw.depth, npop)``, K6b's
    ``ls_stack_bound(sw.depth)``; ``boxes``:
    ``sub_tris(sw, sub)`` for the ``sub`` variant; ``totals``: optional
    (2,) int64 tensor the kernel adds its box and triangle tests to.
    Returns (t, u, v, nrm, prim, inst, st) with st the (R, 2) int32
    per-ray [node visits, leaf visits] when ``stats``, else None.  CUDA
    tensors launch the kernel (or raise); CPU tensors take
    ``trace_lab_plain``."""
    if leaf_stack and pre:
        raise ValueError("leaf_stack + pre is not implemented: _ls_kernel "
                         "has no pre path and would silently time the "
                         "non-pre kernel")
    if sub and (not lean or slim or leaf_stack or leaf_size % sub):
        raise ValueError("sub requires lean, no slim/leaf_stack, and "
                         "leaf_size divisible by sub; pass boxes from "
                         "sub_tris()")
    if sub and boxes is None:
        raise ValueError("sub needs boxes=sub_tris(sw, sub)")
    if npop not in (1, 2, 4):
        raise ValueError(f"npop must be 1, 2 or 4, got {npop}")
    threads = THREADS_PER_ROW * int(tile_s)
    if not 1 <= threads <= 512:
        raise ValueError(f"tile_s {tile_s}: 16 * tile_s threads per block "
                         "must be 1..512")
    if leaf_stack and inv_mats.shape[0] > 1024:
        raise ValueError("leaf_stack entries carry a 10-bit tag")
    rows = min(nodes.shape[0], SMEM_ROWS) if smem_nodes else 0
    check_smem("K6b" if leaf_stack else "K6a", threads, stack, rows)
    t_max = per_ray(t_max, ray_o)
    if ray_o.device.type == "cpu":
        out = trace_lab_plain(nodes, float3_rows(tris4), attrs, inv_mats,
                              ray_o, ray_d, t_min, t_max, leaf_size, stack,
                              npop, ordered, lean, leaf_stack, slim, sub,
                              boxes, noinst)
        return out[:6] + ((out[6][:, :2].contiguous() if stats else None),)

    dev, f32 = ray_o.device, torch.float32
    R, L = ray_o.shape[0], int(leaf_size)
    require("nodes", nodes, (None, 36), f32, dev)
    require("tris4", tris4, (None, 12), f32, dev)
    require("attrs", attrs, (tris4.shape[0], 10), f32, dev)
    require("inv_mats", inv_mats, (None, 12), f32, dev)
    require("ray_o", ray_o, (R, 3), f32, dev)
    require("ray_d", ray_d, (R, 3), f32, dev)
    for name, t in (("nodes", nodes), ("tris4", tris4)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the lab kernels read float4 rows, "
                             f"need a 16-byte aligned tensor")
    if sub:
        require("boxes", boxes, (tris4.shape[0] // L, 6 * sub), f32, dev)
    if totals is not None:
        require("totals", totals, (2,), torch.int64, dev)
    opts = dict(ordered=ordered, fold=fold, pre=pre, slim=slim,
                noinst=noinst, recip=recip, fat=not lean,
                leaf_stack=leaf_stack)
    flags = sum(bit for name, bit in FLAG_BITS.items() if opts[name])
    pre_tbl = pre_ray_state(inv_mats, ray_o, ray_d) if pre else None
    t, u, v = (torch.empty(R, dtype=f32, device=dev) for _ in range(3))
    nrm = torch.empty((R, 3), dtype=f32, device=dev)
    prim, inst = (torch.empty(R, dtype=torch.int32, device=dev)
                  for _ in range(2))
    st = torch.empty((R, 2), dtype=torch.int32, device=dev) if stats else None
    args = (nodes.data_ptr(), rows, tris4.data_ptr(),
            attrs.data_ptr(), pointer(boxes if sub else None), int(sub),
            inv_mats.data_ptr(), pointer(pre_tbl), ray_o.data_ptr(),
            ray_d.data_ptr(), t_max.data_ptr(), float(t_min), R, L,
            int(stack), flags, int(npop), threads, t.data_ptr(),
            u.data_ptr(), v.data_ptr(), nrm.data_ptr(), prim.data_ptr(),
            inst.data_ptr(), pointer(st), pointer(totals))
    (ls_kernel if leaf_stack else lab_kernel)(args, stream_handle(dev))
    return t, u, v, nrm, prim, inst, st
