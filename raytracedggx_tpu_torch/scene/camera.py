"""Camera: view/projection state matching the reference defaults.

Torch port of raytracedggx_tpu/scene/camera.py (RayTracedGGX.cpp:266-278):
fovY = pi/4, zNear = 1, zFar = 1000, eye = (10, 10, -24),
focus = (0, 3, 0), up = +Y, left-handed.  ``OrbitController`` is the
reference's mouse orbit and wheel dolly, in numpy float32 as there.
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


class OrbitController:
    """The reference's runtime camera interactions, headless: mouse-drag
    orbit (OnMouseMove, RayTracedGGX.cpp:412-441) rotates the camera
    about the focus point in VIEW space -- view' = view @ T(0,0,-len) @
    R(pitch,yaw) @ T(0,0,len) with len = |focus - eye| -- and the mouse
    wheel (OnMouseWheel, :442-455) dollies along the view axis by
    len * delta / 16.  Holds the view matrix as state (the reference's
    m_view) and emits (view_proj, proj_to_world, eye) host tensors for
    ``Renderer.step(cam=...)``."""

    def __init__(self, camera: Camera):
        self.camera = camera
        self.view = np.asarray(camera.view())
        self.eye = np.asarray(camera.eye, np.float32)
        self.focus = np.asarray(camera.focus, np.float32)

    def _apply(self, transform):
        view = self.view @ np.asarray(transform, np.float32)
        self.eye = np.linalg.inv(view)[3, :3].astype(np.float32)
        self.view = view

    def drag(self, dx: float, dy: float):
        """Left-drag by (dx, dy) pixels (new - old mouse position).  The
        reference forms dPos = old - new, radians = 2*pi * dPos / viewport
        (RayTracedGGX.cpp:416-420)."""
        rx = 2.0 * np.pi * (-dy) / self.camera.height
        ry = 2.0 * np.pi * (-dx) / self.camera.width
        length = float(np.linalg.norm(self.focus - self.eye))
        t = (np.asarray(m3.translation(0.0, 0.0, -length))
             @ np.asarray(m3.rotation_roll_pitch_yaw(rx, ry))
             @ np.asarray(m3.translation(0.0, 0.0, length)))
        self._apply(t)

    def wheel(self, delta: float):
        """Mouse-wheel dolly: +delta moves toward the focus point
        (RayTracedGGX.cpp:442-455; delta in wheel notches, len/16 per)."""
        length = float(np.linalg.norm(self.focus - self.eye))
        self._apply(m3.translation(0.0, 0.0, -length * delta / 16.0))

    def arrays(self):
        """(view_proj (4, 4), proj_to_world (4, 4), eye (3,)) float32 CPU
        tensors for ``Renderer.step(cam=...)``."""
        vp = torch.as_tensor(self.view, dtype=torch.float32) \
            @ self.camera.proj()
        return vp, torch.linalg.inv(vp), torch.as_tensor(self.eye)
