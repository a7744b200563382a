"""Per-mesh geometry tensors: positions, normals, triangles, the
Moller-Trumbore precompute, each mesh's object-space root box, the packed
per-triangle attribute table the vertex-fetch shading route gathers from,
and each mesh's LBVH for the plain wavefront traversal."""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..bvh.lbvh import build_lbvh


class MeshGeom(NamedTuple):
    positions: torch.Tensor  # (V, 3) float32, object space
    normals: torch.Tensor    # (V, 3)
    tri: torch.Tensor        # (T, 3) int64
    v0: torch.Tensor         # (T, 3) Moller-Trumbore precompute
    e1: torch.Tensor         # (T, 3) v1 - v0
    e2: torch.Tensor         # (T, 3) v2 - v0


class SceneGeometry(NamedTuple):
    meshes: Tuple[MeshGeom, ...]
    bounds: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # per mesh lo, hi
    # packed attribute rows [p0 p1 p2 n0 n1 n2] per triangle, all meshes
    # concatenated; attrib_off[mesh] = first row of that mesh
    attrib: torch.Tensor = None         # (sum_T, 18) float32
    attrib_off: Tuple[int, ...] = ()
    blas: Tuple = ()     # per-mesh LBVH

    @property
    def tri_data(self):
        return [(m.v0, m.e1, m.e2) for m in self.meshes]


def upload_mesh(mesh, device=None) -> MeshGeom:
    tri = np.asarray(mesh.indices, np.int64).reshape(-1, 3)
    pos = np.asarray(mesh.positions, np.float32)
    v = pos[tri]

    def dev(x):
        return torch.as_tensor(x, device=device)

    return MeshGeom(positions=dev(pos),
                    normals=dev(np.asarray(mesh.normals, np.float32)),
                    tri=dev(tri), v0=dev(v[:, 0]), e1=dev(v[:, 1] - v[:, 0]),
                    e2=dev(v[:, 2] - v[:, 0]))


def mesh_bounds(g: MeshGeom):
    """Object-space root box: bounds of the mesh's triangle vertices."""
    p = g.positions[g.tri.reshape(-1)]
    return p.amin(dim=0), p.amax(dim=0)


def upload_scene(scene, device=None) -> SceneGeometry:
    """Upload every mesh and build each mesh's LBVH."""
    meshes = tuple(upload_mesh(m, device) for m in scene.meshes)
    offs, rows, off = [], [], 0
    for m in scene.meshes:
        tri = np.asarray(m.indices, np.int64).reshape(-1, 3)
        p = np.asarray(m.positions, np.float32)[tri].reshape(-1, 9)
        n = np.asarray(m.normals, np.float32)[tri].reshape(-1, 9)
        rows.append(np.concatenate([p, n], axis=1))
        offs.append(off)
        off += tri.shape[0]
    return SceneGeometry(
        meshes=meshes, bounds=tuple(mesh_bounds(g) for g in meshes),
        attrib=torch.as_tensor(np.concatenate(rows), device=device),
        attrib_off=tuple(offs),
        blas=tuple(build_lbvh(g.positions, g.tri.reshape(-1))
                   for g in meshes))


@functools.lru_cache(maxsize=None)
def _instance_rows(offsets, limits, device):
    """Per-instance first attribute row and last triangle, built once per
    scene layout and device (a per-frame tensor would copy from the host)."""
    return (torch.tensor(offsets, device=device),
            torch.tensor(limits, device=device))


def fetch_vertices(geom: SceneGeometry, mesh_ids, inst, prim):
    """getVertices (RayTracing.hlsl:230-244): the 3 object-space vertex
    positions and normals of (inst, prim), one gather from the packed
    table.  Returns ((R, 3, 3), (R, 3, 3)); where inst is not an instance
    (a miss) row 0 is read and the caller masks."""
    off, lim = _instance_rows(
        tuple(geom.attrib_off[m] for m in mesh_ids),
        tuple(geom.meshes[m].tri.shape[0] - 1 for m in mesh_ids), inst.device)
    valid = (inst >= 0) & (inst < len(mesh_ids))
    ic = torch.clamp(inst, 0, len(mesh_ids) - 1)
    row = torch.where(valid, off[ic] + torch.clamp(prim, min=0).minimum(
        lim[ic]), 0)
    vals = geom.attrib[row]                                 # (R, 18)
    return (vals[..., 0:9].reshape(inst.shape + (3, 3)),
            vals[..., 9:18].reshape(inst.shape + (3, 3)))


def interp_attribs(geom: SceneGeometry, mesh_ids, inst, prim, u, v):
    """interpAttrib (RayTracing.hlsl:249-271): barycentric-interpolated
    object-space position and (unnormalised) normal at (inst, prim, u, v)."""
    p, n = fetch_vertices(geom, mesh_ids, inst, prim)
    return interp_from_vertices(p, n, u, v)


def interp_from_vertices(p, n, u, v):
    w0 = (1.0 - u - v)[..., None]
    w1 = u[..., None]
    w2 = v[..., None]
    pos = w0 * p[..., 0, :] + w1 * p[..., 1, :] + w2 * p[..., 2, :]
    nrm = w0 * n[..., 0, :] + w1 * n[..., 1, :] + w2 * n[..., 2, :]
    return pos, nrm
