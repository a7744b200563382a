"""Ray-triangle (Moller-Trumbore) and ray-AABB (slab) tests.

Torch port of raytracedggx_tpu/trace/intersect.py.  Barycentrics follow
the DXR convention: (u, v) weigh vertices 1 and 2, w0 = 1 - u - v.
"""

from __future__ import annotations

import torch


def moller_trumbore(ray_o, ray_d, v0, e1, e2, t_min, t_max):
    """Intersect rays with per-ray triangles (all args (..., 3)).

    e1 = v1 - v0, e2 = v2 - v0.  Returns (t, u, v, hit).  No backface
    culling.  A degenerate determinant gives NaN, which fails every
    comparison, so it counts as a miss.  Arguments broadcast.
    """
    pvec = torch.linalg.cross(ray_d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    inv_det = 1.0 / det
    tvec = ray_o - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    v = torch.sum(ray_d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min) \
        & (t <= t_max)
    return t, u, v, hit


def ray_aabb(ray_o, inv_d, box_min, box_max, t_min, t_max):
    """Slab test.  Returns (t_near, hit); inv_d from ``safe_inv_dir``."""
    t0 = (box_min - ray_o) * inv_d
    t1 = (box_max - ray_o) * inv_d
    tnear = torch.amax(torch.minimum(t0, t1), dim=-1)
    tfar = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tnear <= tfar) & (tfar >= t_min) & (tnear <= t_max)
    return tnear, hit


def safe_inv_dir(ray_d, eps=1e-20):
    """1/d with zero components clamped to +-eps first."""
    d = torch.where(torch.abs(ray_d) < eps,
                    torch.where(ray_d >= 0, eps, -eps), ray_d)
    return 1.0 / d
