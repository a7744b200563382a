"""Closest-hit traversal in plain torch: the wavefront trace and the
instance walk.

Torch port of raytracedggx_tpu/trace/traverse.py.  ``trace_rays`` is the
synchronous wavefront: every ray advances one step of its own 64-deep
stack per iteration until no ray is active (``traversal="jax"``, the
route by which the reference rendered its cube goldens).

``trace_scene`` walks only the (ray, instance) pairs whose world box the
ray enters, all pairs of a mesh in one wavefront, so its steps do not
grow with the number of instances; it gives, bit for bit, what
``trace_scene_sequential`` (one whole-wave walk per instance, in
instance order) gives.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from .. import _precision  # noqa: F401  (float32 matmuls at full precision)
from ..bvh.lbvh import LBVH
from .intersect import moller_trumbore, ray_aabb, safe_inv_dir

STACK_DEPTH = 64
# ray-box tests one slab-test chunk of the instance cull holds (each of its
# few (chunk, 3) float32 temporaries 192 MiB)
BOX_TESTS = 1 << 24
# pairs one wavefront walks at a time: its (pairs, STACK_DEPTH) int64
# stack is 2 GiB
WALK_PAIRS = 1 << 22
# the cull's world boxes grow by this share of their size and of their
# distance from the origin, so that rounding never drops a pair whose
# object-space root box the walk would enter
BOX_PAD = 1e-4


class HitRecord(NamedTuple):
    t: torch.Tensor        # (R,) float32 (t_max where missed)
    prim: torch.Tensor     # (R,) int64 mesh-local triangle id (-1 = miss)
    u: torch.Tensor        # (R,) float32 barycentric of vertex 1
    v: torch.Tensor        # (R,) float32 barycentric of vertex 2
    hit: torch.Tensor      # (R,) bool
    inst: torch.Tensor     # (R,) int64 instance id (-1 = miss)


def per_ray(x, like):
    """x (a python number or a tensor broadcasting to (R,)) as a
    contiguous (R,) float32 tensor on the rays' device; a number is filled
    in on the device, with no copy from the host."""
    if torch.is_tensor(x):
        return x.to(torch.float32).expand(like.shape[0]).contiguous()
    return torch.full((like.shape[0],), float(x), device=like.device)


def trace_rays(bvh: LBVH, tri_v0, tri_e1, tri_e2, ray_o, ray_d, t_min,
               t_max) -> HitRecord:
    """Closest hit of (R, 3) rays against one LBVH; tri_* (T, 3) in
    ORIGINAL triangle order (leaf_tri indexes them)."""
    R = ray_o.shape[0]
    dev = ray_o.device
    n_int = bvh.num_internal
    n_leaves = bvh.num_leaves
    inv_d = safe_inv_dir(ray_d)
    t_min = per_ray(t_min, ray_o)
    best_t = per_ray(t_max, ray_o).clone()

    # cheap root cull so rays that miss the whole mesh take no step
    _, active = ray_aabb(ray_o, inv_d, bvh.aabb_min[0], bvh.aabb_max[0],
                         t_min, best_t)
    node = torch.zeros(R, dtype=torch.int64, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    stack = torch.zeros((R, STACK_DEPTH), dtype=torch.int64, device=dev)
    best_prim = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(R, device=dev)
    best_v = torch.zeros(R, device=dev)
    rows = torch.arange(R, device=dev)
    left, right = bvh.left, bvh.right
    amin, amax = bvh.aabb_min, bvh.aabb_max

    while bool(active.any()):
        is_leaf = node >= n_int
        # leaf: intersect its triangle
        prim = bvh.leaf_tri[torch.clamp(node - n_int, 0, n_leaves - 1)]
        t, u, v, hit = moller_trumbore(ray_o, ray_d, tri_v0[prim],
                                       tri_e1[prim], tri_e2[prim], t_min,
                                       best_t)
        take = active & is_leaf & hit
        best_t = torch.where(take, t, best_t)
        best_prim = torch.where(take, prim, best_prim)
        best_u = torch.where(take, u, best_u)
        best_v = torch.where(take, v, best_v)

        # internal: test both children
        nidx = torch.clamp(node, 0, n_int - 1)
        lc, rc = left[nidx], right[nidx]
        tl, hl = ray_aabb(ray_o, inv_d, amin[lc], amax[lc], t_min, best_t)
        tr, hr = ray_aabb(ray_o, inv_d, amin[rc], amax[rc], t_min, best_t)
        both = hl & hr & ~is_leaf
        near = torch.where(tl <= tr, lc, rc)
        far = torch.where(tl <= tr, rc, lc)
        one = (hl ^ hr) & ~is_leaf
        one_child = torch.where(hl, lc, rc)

        # push the far child when both hit
        push = active & both
        slot = torch.clamp(sp, max=STACK_DEPTH - 1)
        stack[rows, slot] = torch.where(push, far, stack[rows, slot])
        sp = torch.where(push, sp + 1, sp)

        # next node: descend or pop
        descend = ~is_leaf & (both | one)
        next_desc = torch.where(both, near, one_child)
        can_pop = active & ~descend & (sp > 0)
        sp = torch.where(can_pop, sp - 1, sp)
        popped = stack[rows, torch.clamp(sp, 0, STACK_DEPTH - 1)]
        node = torch.where(active, torch.where(descend, next_desc, popped),
                           node)
        active = active & (descend | can_pop)

    hit = best_prim >= 0
    return HitRecord(t=best_t, prim=best_prim, u=best_u, v=best_v, hit=hit,
                     inst=torch.where(hit, 0, -1))


def merge_instance(best: HitRecord | None, rec: HitRecord, i: int
                   ) -> HitRecord:
    """Fold instance i's hits into the closest so far (the reference's
    per-instance merge: a later instance wins only when strictly closer)."""
    rec = rec._replace(inst=torch.where(rec.hit, i, -1))
    if best is None:
        return rec
    closer = rec.hit & (rec.t < best.t)
    return HitRecord(
        t=torch.where(closer, rec.t, best.t),
        prim=torch.where(closer, rec.prim, best.prim),
        u=torch.where(closer, rec.u, best.u),
        v=torch.where(closer, rec.v, best.v),
        hit=best.hit | rec.hit,
        inst=torch.where(closer, rec.inst, best.inst))


def to_object(inv_world, ray_o, ray_d):
    """World rays into an instance's object space (row-vector inverse
    world (4, 4)); the direction stays unnormalised, so t keeps world
    units."""
    m = inv_world[:3, :3]
    return ray_o @ m + inv_world[3, :3], ray_d @ m


def trace_scene_sequential(blas_list, tri_data, tlas, ray_o, ray_d, t_min,
                           t_max) -> HitRecord:
    """Closest hit across all TLAS instances, one whole-wave walk per
    instance in instance order; later instances are pruned by the best t
    so far.  blas_list: per-mesh LBVH; tri_data: per-mesh (v0, e1, e2).
    What ``trace_scene`` must equal; no run calls it."""
    best = None
    for i, mesh_id in enumerate(tlas.mesh_ids):
        o, d = to_object(tlas.inv_worlds[i], ray_o, ray_d)
        v0, e1, e2 = tri_data[mesh_id]
        rec = trace_rays(blas_list[mesh_id], v0, e1, e2, o, d, t_min,
                         t_max if best is None else best.t)
        best = merge_instance(best, rec, i)
    return best


def instance_pairs(tlas, ray_o, ray_d, t_min, t_max):
    """(ray, instance) int64 indices of the pairs whose instance's world
    box (grown by BOX_PAD) the ray enters between t_min and t_max ((R,)
    each), in instance order and in ray order within an instance; slab
    tests in chunks of at most BOX_TESTS."""
    R, n_inst = ray_o.shape[0], tlas.aabb_min.shape[0]
    lo, hi = tlas.aabb_min, tlas.aabb_max
    size = (hi - lo).amax(-1, keepdim=True)
    far = torch.maximum(lo.abs(), hi.abs()).amax(-1, keepdim=True)
    pad = BOX_PAD * (size + far)
    lo, hi = lo - pad, hi + pad
    inv_d = safe_inv_dir(ray_d)
    per_rays = max(1, min(R, BOX_TESTS))
    per_insts = max(1, BOX_TESTS // per_rays)
    rays, insts = [], []
    for i0 in range(0, n_inst, per_insts):
        i1 = min(i0 + per_insts, n_inst)
        for r0 in range(0, R, per_rays):
            r1 = min(r0 + per_rays, R)
            _, enter = ray_aabb(ray_o[None, r0:r1], inv_d[None, r0:r1],
                                lo[i0:i1, None], hi[i0:i1, None],
                                t_min[None, r0:r1], t_max[None, r0:r1])
            i, r = enter.nonzero(as_tuple=True)
            insts.append(i + i0)
            rays.append(r + r0)
    empty = torch.zeros(0, dtype=torch.int64, device=ray_o.device)
    return (torch.cat(rays) if rays else empty,
            torch.cat(insts) if insts else empty)


def trace_scene(blas_list, tri_data, tlas, ray_o, ray_d, t_min, t_max
                ) -> HitRecord:
    """Closest hit across all TLAS instances, as ``trace_scene_sequential``
    gives it, walking only the pairs ``instance_pairs`` keeps.

    Each pair's ray is the row of the whole wave that ``to_object`` puts
    into its instance's object space, as the sequential walk does (the
    same product over fewer rows may round otherwise: the CPU's BLAS
    does), and all pairs of a mesh are walked in one wavefront
    (WALK_PAIRS at a time) up to the ray's own t_max.  The sequential
    merge keeps, for each ray, the closest hit, and on equal t the lowest
    instance; an instance after the first counts only strictly below
    t_max; ``hit`` is set where any instance was hit."""
    R, dev = ray_o.shape[0], ray_o.device
    t_min, t_max = per_ray(t_min, ray_o), per_ray(t_max, ray_o)
    rays, insts = instance_pairs(tlas, ray_o, ray_d, t_min, t_max)
    n_inst = len(tlas.mesh_ids)
    counts = torch.bincount(insts, minlength=n_inst).tolist()
    starts = [0, *itertools.accumulate(counts)]
    P = rays.shape[0]
    t = torch.empty(P, device=dev)
    prim = torch.empty(P, dtype=torch.int64, device=dev)
    u = torch.empty(P, device=dev)
    v = torch.empty(P, device=dev)
    hit = torch.empty(P, dtype=torch.bool, device=dev)
    for mesh_id in sorted(set(tlas.mesh_ids)):
        spans = [(i, starts[i], starts[i + 1])
                 for i, m in enumerate(tlas.mesh_ids)
                 if m == mesh_id and counts[i]]
        if not spans:
            continue
        o, d = [], []
        for i, a, b in spans:
            wo, wd = to_object(tlas.inv_worlds[i], ray_o, ray_d)
            o.append(wo[rays[a:b]])
            d.append(wd[rays[a:b]])
        o, d = torch.cat(o), torch.cat(d)
        at = torch.cat([torch.arange(a, b, device=dev) for _, a, b in spans])
        v0, e1, e2 = tri_data[mesh_id]
        for c0 in range(0, at.shape[0], WALK_PAIRS):
            c = at[c0:c0 + WALK_PAIRS]
            r = rays[c]
            rec = trace_rays(blas_list[mesh_id], v0, e1, e2,
                             o[c0:c0 + WALK_PAIRS], d[c0:c0 + WALK_PAIRS],
                             t_min[r], t_max[r])
            t[c], prim[c], u[c], v[c], hit[c] = (rec.t, rec.prim, rec.u,
                                                 rec.v, rec.hit)
    # the sequential merge: the closest hit, the lowest instance on a tie
    counted = hit & ((insts == 0) | (t < t_max[rays]))
    closest = t_max.clone()
    closest.scatter_reduce_(0, rays[counted], t[counted], "amin")
    tied = counted & (t == closest[rays])
    first = torch.full((R,), n_inst, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, rays[tied], insts[tied], "amin")
    won = tied & (insts == first[rays])
    w = rays[won]
    out_t = t_max.clone()
    out_prim = torch.full((R,), -1, dtype=torch.int64, device=dev)
    out_u = torch.zeros(R, device=dev)
    out_v = torch.zeros(R, device=dev)
    out_inst = torch.full((R,), -1, dtype=torch.int64, device=dev)
    out_t[w], out_prim[w], out_u[w], out_v[w], out_inst[w] = (
        t[won], prim[won], u[won], v[won], insts[won])
    out_hit = torch.zeros(R, dtype=torch.bool, device=dev)
    out_hit[rays[hit]] = True
    return HitRecord(t=out_t, prim=out_prim, u=out_u, v=out_v, hit=out_hit,
                     inst=out_inst)
