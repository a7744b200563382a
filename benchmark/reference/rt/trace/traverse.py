"""Closest-hit traversal in plain torch: the wavefront trace and the
per-instance loop.

Torch port of raytracedggx_tpu/trace/traverse.py.  ``trace_rays`` is the
synchronous wavefront: every ray advances one step of its own 64-deep
stack per iteration until no ray is active (``traversal="jax"``, the
route by which the reference rendered its cube goldens).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _precision  # noqa: F401  (float32 matmuls at full precision)
from ..bvh.lbvh import LBVH
from .intersect import moller_trumbore, ray_aabb, safe_inv_dir

STACK_DEPTH = 64


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


def trace_scene(blas_list, tri_data, tlas, ray_o, ray_d, t_min, t_max
                ) -> HitRecord:
    """Closest hit across all TLAS instances; later instances are pruned
    by the best t so far.  blas_list: per-mesh LBVH; tri_data: per-mesh
    (v0, e1, e2)."""
    best = None
    for i, mesh_id in enumerate(tlas.mesh_ids):
        o, d = to_object(tlas.inv_worlds[i], ray_o, ray_d)
        v0, e1, e2 = tri_data[mesh_id]
        rec = trace_rays(blas_list[mesh_id], v0, e1, e2, o, d, t_min,
                         t_max if best is None else best.t)
        best = merge_instance(best, rec, i)
    return best
