"""Materials: base colors + roughness/metallic per mesh.

Defaults from RayTracer.cpp:134-139 — mesh 0 (ground) silver
(0.95, 0.93, 0.88) roughness 0.5, mesh 1 (model) gold (1.0, 0.71, 0.29)
roughness 0.16, both metallic 1.0.  Metallic is runtime-mutable in 0.25
steps (RayTracedGGX.cpp:380-387 hotkeys; RayTracer::SetMetallic).

The ground gets a procedural checkerboard roughness at shade time
(Material.hlsli:30-40): 5x5 tiles over UV, alternate tiles roughness*0.25.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Materials:
    base_colors: np.ndarray   # (NUM_MESH, 4) float32
    rough_metals: np.ndarray  # (NUM_MESH, 2) float32


def default_materials() -> Materials:
    return Materials(
        base_colors=np.array([
            [0.95, 0.93, 0.88, 1.0],   # silver ground
            [1.00, 0.71, 0.29, 1.0],   # gold model
        ], np.float32),
        rough_metals=np.array([
            [0.5, 1.0],
            [0.16, 1.0],
        ], np.float32),
    )
