"""Camera: view/projection state matching the reference defaults.

Torch port of raytracedggx_tpu/scene/camera.py (RayTracedGGX.cpp:266-278):
fovY = pi/4, zNear = 1, zFar = 1000, eye = (10, 10, -24),
focus = (0, 3, 0), up = +Y, left-handed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils import math3d as m3


@dataclass
class Camera:
    width: int = 1280
    height: int = 720
    fov_y: float = float(np.pi / 4)
    z_near: float = 1.0
    z_far: float = 1000.0
    eye: np.ndarray = field(
        default_factory=lambda: np.array([10.0, 10.0, -24.0], np.float32))
    focus: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 3.0, 0.0], np.float32))
    up: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))

    @property
    def aspect(self) -> float:
        return self.width / float(self.height)

    def view(self):
        return m3.look_at_lh(self.eye, self.focus, self.up)

    def proj(self):
        return m3.perspective_fov_lh(self.fov_y, self.aspect, self.z_near,
                                     self.z_far)

    def view_proj(self):
        """(4, 4) float32 CPU tensor."""
        return self.view() @ self.proj()
