"""Scene: ground slab + animated model instances.

Torch port of raytracedggx_tpu/scene/scene.py.  Instance transforms per
frame (RayTracer::UpdateFrame, RayTracer.cpp:269-279):

- mesh 0 (ground): scaling(8, 0.5, 8) * translation(0, -0.5, 0)    [static]
- mesh 1 (model):  scaling(s) * rotationY(angle) * translation(pos)

Matrices are row-vector (``p @ M``) float32 CPU tensors; callers move them
to their device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..utils import math3d as m3
from .material import Materials
from .mesh import Mesh

GROUND = 0
MODEL = 1
NUM_MESH = 2


@dataclass
class Scene:
    meshes: List[Mesh]
    materials: Materials
    pos_scale: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0], np.float32))
    ground_scale: float = 8.0

    @property
    def mesh_ids(self):
        """Instance -> mesh index (instance 0 = ground, 1 = the model)."""
        return (0, 1)

    def instance_materials(self) -> Materials:
        """Per-INSTANCE material arrays (instances share their mesh's
        material, matching the reference's per-mesh CBMaterial)."""
        ids = list(self.mesh_ids)
        return Materials(base_colors=self.materials.base_colors[ids].copy(),
                         rough_metals=self.materials.rough_metals[ids].copy())

    def _model_world(self, angle, pos_scale):
        s = float(pos_scale[3])
        return (m3.scaling(s, s, s) @ m3.rotation_y(angle)
                @ m3.translation(*[float(v) for v in pos_scale[:3]]))

    def worlds(self, angle):
        """(I, 4, 4) world matrices for animation angle."""
        g = float(self.ground_scale)
        ground = m3.scaling(g, 0.5, g) @ m3.translation(0.0, -0.5, 0.0)
        return torch.stack([ground, self._model_world(angle, self.pos_scale)])

    def normal_matrices(self, worlds):
        """(I, 3, 3) inverse-transpose normal matrices."""
        return torch.linalg.inv(worlds[:, :3, :3]).transpose(1, 2)
