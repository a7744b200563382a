"""Scene: ground slab + animated model instances.

Torch port of raytracedggx_tpu/scene/scene.py.  Instance transforms per
frame (RayTracer::UpdateFrame, RayTracer.cpp:269-279):

- mesh 0 (ground): scaling(8, 0.5, 8) * translation(0, -0.5, 0)    [static]
- mesh 1 (model):  scaling(s) * rotationY(angle) * translation(pos)
- each extra instance of the model, after those two, placed as the model
  is at its own (x, y, z, s): the same angle about its own origin

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


def model_world(angle, pos_scale):
    """scaling(s) * rotationY(angle) * translation(x, y, z) of a model
    instance placed at pos_scale (x, y, z, s)."""
    s = float(pos_scale[3])
    return (m3.scaling(s, s, s) @ m3.rotation_y(angle)
            @ m3.translation(*[float(v) for v in pos_scale[:3]]))


def instance_worlds(angle, pos_scale, extra_instances=(), ground_scale=8.0):
    """(I, 4, 4) world matrices at animation angle: the ground, the model
    at pos_scale, then each extra instance (x, y, z, s) in order."""
    g = float(ground_scale)
    ground = m3.scaling(g, 0.5, g) @ m3.translation(0.0, -0.5, 0.0)
    return torch.stack([ground, model_world(angle, pos_scale)]
                       + [model_world(angle, ps) for ps in extra_instances])


@dataclass
class Scene:
    meshes: List[Mesh]
    materials: Materials
    pos_scale: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0], np.float32))
    # additional instances of the model, each (x, y, z, scale)
    extra_instances: tuple = ()
    ground_scale: float = 8.0

    @property
    def mesh_ids(self):
        """Instance -> mesh index (instance 0 = ground, rest = the model)."""
        return (0, 1) + (1,) * len(self.extra_instances)

    def instance_materials(self) -> Materials:
        """Per-INSTANCE material arrays (instances share their mesh's
        material, matching the reference's per-mesh CBMaterial)."""
        ids = list(self.mesh_ids)
        return Materials(base_colors=self.materials.base_colors[ids].copy(),
                         rough_metals=self.materials.rough_metals[ids].copy())

    def worlds(self, angle):
        """(I, 4, 4) world matrices for animation angle."""
        return instance_worlds(angle, self.pos_scale, self.extra_instances,
                               self.ground_scale)

    def normal_matrices(self, worlds):
        """(I, 3, 3) inverse-transpose normal matrices."""
        return torch.linalg.inv(worlds[:, :3, :3]).transpose(1, 2)
