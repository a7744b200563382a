"""Mesh containers + the procedural ground cube (numpy host data).

Copied from raytracedggx_tpu/scene/mesh.py.

The reference scene has exactly two meshes (Material.hlsli:5 NUM_MESH=2):
mesh 0 = a 24-vertex cube used as the ground slab
(RayTracer::createGroundMesh, RayTracer.cpp:423-511), mesh 1 = the OBJ model
(bunny / dragon / TuringBowl).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np



@dataclass
class Mesh:
    positions: np.ndarray  # (V, 3) float32, object space
    normals: np.ndarray    # (V, 3) float32
    indices: np.ndarray    # (3T,) uint32

    @property
    def num_triangles(self) -> int:
        return len(self.indices) // 3


def ground_cube() -> Mesh:
    """24-vertex unit cube with per-face normals; vertex order and indices
    match RayTracer.cpp:431-505 so primitive ids agree with the reference."""
    p = np.array([
        [-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1],          # +Y
        [-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1],      # -Y
        [-1, -1, 1], [-1, -1, -1], [-1, 1, -1], [-1, 1, 1],      # -X
        [1, -1, 1], [1, -1, -1], [1, 1, -1], [1, 1, 1],          # +X
        [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],      # -Z
        [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],          # +Z
    ], np.float32)
    n = np.repeat(np.array([
        [0, 1, 0], [0, -1, 0], [-1, 0, 0], [1, 0, 0], [0, 0, -1], [0, 0, 1],
    ], np.float32), 4, axis=0)
    idx = np.array([
        3, 1, 0, 2, 1, 3,
        6, 4, 5, 7, 4, 6,
        11, 9, 8, 10, 9, 11,
        14, 12, 13, 15, 12, 14,
        19, 17, 16, 18, 17, 19,
        22, 20, 21, 23, 20, 22,
    ], np.uint32)
    return Mesh(p, n, idx)
