"""Top-level instance table: world transforms + world AABBs.

Torch port of raytracedggx_tpu/bvh/tlas.py (RayTracer::
UpdateAccelerationStructure, RayTracer.cpp:326-341).  The reference reads
each mesh's root box from its LBVH (``aabb_min[0]``); that box is the
union of the mesh's triangle bounds, so the port takes it from
``trace.geometry.mesh_bounds`` and needs no LBVH.  ``inv_worlds`` are
what the per-mesh traversals (``traversal="pallas"``, ``"pallas4"`` and
``"jax"``) move rays into object space with.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _precision  # noqa: F401  (float32 matmuls at full precision)


class TLAS(NamedTuple):
    worlds: torch.Tensor        # (I, 4, 4) row-vector world matrices
    inv_worlds: torch.Tensor    # (I, 4, 4)
    aabb_min: torch.Tensor      # (I, 3) world-space instance bounds
    aabb_max: torch.Tensor      # (I, 3)
    mesh_ids: tuple             # instance -> mesh index


def _corners(lo, hi):
    """(..., 8, 3) box corners, x fastest (bit 0 = x, 1 = y, 2 = z)."""
    c = torch.arange(8, device=lo.device)
    sel = torch.stack([(c >> k) & 1 for k in range(3)], dim=-1).bool()
    return torch.where(sel, hi[..., None, :], lo[..., None, :])


def build_tlas(mesh_bounds, worlds, mesh_ids, inv_worlds=None) -> TLAS:
    """mesh_bounds: per mesh (lo (3,), hi (3,)) object-space root boxes;
    worlds (I, 4, 4); mesh_ids: instance -> mesh; inv_worlds: the
    worlds' inverses where the caller has them (else computed here)."""
    if inv_worlds is None:
        inv_worlds = torch.linalg.inv_ex(worlds).inverse    # no host sync
    lo = torch.stack([mesh_bounds[m][0] for m in mesh_ids])
    hi = torch.stack([mesh_bounds[m][1] for m in mesh_ids])
    wc = (torch.einsum("icd,ide->ice", _corners(lo, hi), worlds[:, :3, :3])
          + worlds[:, None, 3, :3])
    return TLAS(worlds=worlds, inv_worlds=inv_worlds, aabb_min=wc.amin(dim=1),
                aabb_max=wc.amax(dim=1), mesh_ids=tuple(mesh_ids))
