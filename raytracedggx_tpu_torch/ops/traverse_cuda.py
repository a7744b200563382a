"""Per-mesh binary-tree traversal: kernel K4 and its plain twin.

Torch/CUDA port of raytracedggx_tpu/ops/traverse_pallas.py:200-263
(``trace_rays_pallas``) and :399-437 (``trace_scene_pallas``), the
``traversal="pallas"`` backend.  The TPU kernel ``_traverse_kernel``
becomes the CUDA kernel in ``csrc/traverse_flat.cu``, launched by
``trace_tiles_flat`` with one ray per thread over the tree's float4
copies (``FlatBVH.pairs`` and ``tris4``).  Its plain version is
``trace_stream_plain``: the brute-force oracle ``trace_bruteforce`` over
the stream-ordered triangles, independent of the tree.

``trace_scene_flat`` is the per-instance loop: rays go to each
instance's object space (inside the kernel, through the inverse world;
with torch ops in the plain version), later instances are pruned by the
best t so far, dead rays keep t_max = -1, and a hit gets inst = i and
prim = tri_perm[stream position].
"""

from __future__ import annotations

import torch

from ..trace.traverse import (HitRecord, merge_instance, per_ray,
                              trace_bruteforce)
from .cuda_lib import (check_launch, load_library, pointer, require,
                       stream_handle)
from .flatten import FlatBVH


def inv_rows(inv_worlds):
    """(I, 4, 4) row-vector inverse worlds -> (I, 12) rows: the 3x3
    row-major, then the translation (the kernels' layout)."""
    n = inv_worlds.shape[0]
    return torch.cat([inv_worlds[:, :3, :3].reshape(n, 9),
                      inv_worlds[:, 3, :3]], dim=1).contiguous()


def trace_stream_plain(tris, ray_o, ray_d, t_min, t_max, inv=None):
    """Plain version of K4 and K5: brute force over the (T, 9) stream
    rows; returns (t, u, v, stream position int32)."""
    if inv is not None:    # to object space with torch ops (to_object)
        m = inv[:9].reshape(3, 3)
        ray_o, ray_d = ray_o @ m + inv[9:], ray_d @ m
    rec = trace_bruteforce(tris[:, 0:3], tris[:, 3:6], tris[:, 6:9], ray_o,
                           ray_d, t_min, t_max)
    return rec.t, rec.u, rec.v, rec.prim.to(torch.int32)


def launch_outputs(ray_o, ray_d, inv, stats, rows):
    """Check the inputs of a K4 or K5 launch and allocate its outputs (t,
    u, v, stream position).  rows: {name: (tensor, shape)}, the tree's
    rows that the kernel reads as float4: contiguous float32 on the rays'
    device, 16-byte aligned."""
    dev, f32 = ray_o.device, torch.float32
    R = ray_o.shape[0]
    for name, (t, shape) in rows.items():
        require(name, t, shape, f32, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads float4 rows, need "
                             f"a 16-byte aligned tensor")
    require("ray_o", ray_o, (R, 3), f32, dev)
    require("ray_d", ray_d, (R, 3), f32, dev)
    if inv is not None:
        require("inv", inv, (12,), f32, dev)
    if stats is not None:
        require("stats", stats, (2,), torch.int64, dev)
    return tuple(torch.empty(R, dtype=dt, device=dev)
                 for dt in (f32, f32, f32, torch.int32))


def check_stack(kernel, need, cap):
    """Raise unless a tree's stack bound fits the kernel's compiled one."""
    if not 1 <= need <= cap:
        raise ValueError(f"the tree needs a stack of {need}; {kernel} "
                         f"holds {cap}")


def trace_tiles_flat(flat: FlatBVH, ray_o, ray_d, t_min, t_max, inv=None,
                     stats=None):
    """K4 wrapper: closest hit of (R, 3) rays against one FlatBVH, in the
    object space of ``inv`` ((12,) inverse-world row; None: the rays are
    in object space already).  CUDA tensors launch the kernel (or raise:
    a tree deeper than the kernel's compiled stack, or rows that are not
    16-byte aligned); CPU tensors take ``trace_stream_plain``.  Returns
    (t, u, v, stream position int32).  stats: optional (2,) int64 tensor
    the kernel adds its box and triangle tests to.
    Launch counters count calls that launch the kernel: a frame
    captured into a CUDA graph (``Renderer.step_n``) counts once, at
    capture, not at each replay."""
    t_max = per_ray(t_max, ray_o)
    if ray_o.device.type == "cpu":
        return trace_stream_plain(flat.tris, ray_o, ray_d, t_min, t_max,
                                  inv)
    out = launch_outputs(ray_o, ray_d, inv, stats, {
        "pairs": (flat.pairs, (None, 16)),
        "tris4": (flat.tris4, (flat.tris.shape[0], 12))})
    lib = load_library()
    check_stack("K4", flat.stack, lib.rtggx_k4_max_stack())
    err = lib.rtggx_trace_flat(
        flat.pairs.data_ptr(), flat.tris4.data_ptr(), pointer(inv),
        ray_o.data_ptr(), ray_d.data_ptr(), t_max.data_ptr(), float(t_min),
        ray_o.shape[0], int(flat.stack), *(x.data_ptr() for x in out),
        pointer(stats), stream_handle(ray_o.device))
    check_launch(err, "K4 trace_tiles_flat")
    trace_tiles_flat.launches += 1
    return out


trace_tiles_flat.launches = 0


def stream_record(t, u, v, pos, tri_perm) -> HitRecord:
    """HitRecord of one mesh from a stream-position result."""
    hit = pos >= 0
    prim = torch.where(hit, tri_perm[torch.clamp(pos.to(torch.int64), 0)],
                       -1)
    return HitRecord(t=t, prim=prim, u=u, v=v, hit=hit,
                     inst=torch.where(hit, 0, -1))


def trace_rays_tree(kernel, tree, ray_o, ray_d, t_min, t_max, inv=None,
                    impl: str = "cuda") -> HitRecord:
    """Closest hit against one mesh's tree.  impl="cuda" goes through
    ``kernel`` (the K4 or K5 wrapper), impl="xla" takes the plain version
    on any device."""
    if impl == "xla":
        out = trace_stream_plain(tree.tris, ray_o, ray_d, t_min,
                                 per_ray(t_max, ray_o), inv)
    else:
        out = kernel(tree, ray_o.contiguous(), ray_d.contiguous(), t_min,
                     t_max, inv)
    return stream_record(*out, tree.tri_perm)


def trace_scene_trees(kernel, trees, tlas, ray_o, ray_d, t_min, t_max,
                      impl: str = "cuda") -> HitRecord:
    """Closest hit across the TLAS instances, one launch of ``kernel``
    each, later instances pruned by the best t so far."""
    invs = inv_rows(tlas.inv_worlds)
    best = None
    for i, mesh_id in enumerate(tlas.mesh_ids):
        rec = trace_rays_tree(kernel, trees[mesh_id], ray_o, ray_d, t_min,
                              t_max if best is None else best.t, invs[i],
                              impl)
        best = merge_instance(best, rec, i)
    return best


def trace_rays_flat(flat: FlatBVH, ray_o, ray_d, t_min, t_max, inv=None,
                    impl: str = "cuda") -> HitRecord:
    """Closest hit against one FlatBVH (K4; trace_rays_pallas)."""
    return trace_rays_tree(trace_tiles_flat, flat, ray_o, ray_d, t_min,
                           t_max, inv, impl)


def trace_scene_flat(flats, tlas, ray_o, ray_d, t_min, t_max,
                     impl: str = "cuda") -> HitRecord:
    """Closest hit across the TLAS instances, one K4 launch each
    (trace_scene_pallas)."""
    return trace_scene_trees(trace_tiles_flat, flats, tlas, ray_o, ray_d,
                             t_min, t_max, impl)
