"""Per-mesh geometry tensors: the bindless IB/VB analog.

Torch port of the part of raytracedggx_tpu/trace/geometry.py that the
fused frame path reads: per-mesh positions, normals, triangles and the
Moller-Trumbore precompute, plus each mesh's object-space root box (the
reference takes it from a per-mesh LBVH, which the port does not build).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


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
    meshes = tuple(upload_mesh(m, device) for m in scene.meshes)
    return SceneGeometry(meshes=meshes,
                         bounds=tuple(mesh_bounds(g) for g in meshes))
