"""The plain reference frame: what the measured frame loop must produce.

``ReferenceRenderer`` renders the benchmark's scene frame by frame with
the frozen plain code in ``rt/``: the frame's constants worked out on the
host (the animation angle, the Halton jitter, the RNG's frame index, the
instance matrices and their inverses), the TLAS rebuilt from them, the
three ray waves traced by the plain wavefront walk of each mesh's own
LBVH in that instance's object space (no scene BVH and no kernel), the
plain spatial passes, the TAA against the history it is given, and the
tone map.  It takes only what the benchmark made: the model's arrays,
its placement and that of each extra instance, the materials' metallic
values, the resolution and the filter switches.  It imports nothing of
the measured program.

``tf32`` computes every float32 matrix product with its operands rounded
to TF32 (10 mantissa bits, round to nearest), as tensor cores would with
TF32 allowed: the control that the comparison must reject.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from .rt.bvh import build_tlas
from .rt.denoise import (diffuse_spatial_filter, reflection_spatial_filter,
                         temporal_ss)
from .rt.post import tone_map
from .rt.scene import Camera, Mesh, Scene, default_materials, ground_cube
from .rt.sh import project_sh9
from .rt.trace.env import procedural_env
from .rt.trace.geometry import upload_scene
from .rt.trace.raygen import (FrameConstants, MaterialsDev, default_tracer,
                              ray_trace_pass)
from .rt.utils.halton import halton_table

ANIM_SPEED = 16.0 * math.pi / 180.0   # 16 deg/s (RayTracer.cpp:271)
JITTER_TABLE = 1024
RNG_FRAMES = 256                      # FrameIndex mod (RayTracer.cpp:295)
ENV_SIZE = 64                         # the procedural sky's face size


class State(NamedTuple):
    history: torch.Tensor    # (H, W, 4) f16 TAA history
    prev_wvp: torch.Tensor   # (I, 4, 4) previous frame's WVPs
    angle: np.float32        # animation angle
    frame: int               # absolute frame counter


def advance(angle, dt):
    """The animation angle after dt seconds (float32 on the host)."""
    return np.float32(angle + np.float32(ANIM_SPEED) * np.float32(dt))


def to_tf32(x):
    """x rounded to TF32: the low 13 of float32's 23 mantissa bits cleared,
    round to nearest."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


_MATMULS = {torch.matmul, torch.einsum, torch.bmm, torch.mm,
            torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
            torch.Tensor.matmul}


class TF32(TorchFunctionMode):
    """Round the float32 operands of every matrix product to TF32."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _MATMULS:
            args = tuple(to_tf32(a) if torch.is_tensor(a)
                         and a.dtype == torch.float32 else a for a in args)
        return func(*args, **kwargs)


class ReferenceRenderer:
    """The frame of the benchmark's scene in plain torch on ``device``.

    mesh: (positions (V, 3), normals (V, 3), indices (3T,)) of the model,
    in the object space the renderer loads (DirectX handedness);
    pos_scale: its placement (x, y, z, scale) over the ground cube;
    metallic: {mesh index: value} set before the first frame;
    extra_instances: ((x, y, z, scale), ...) of further instances of the
    model, after the first."""

    def __init__(self, mesh, pos_scale, width, height, metallic=None,
                 spatial=True, temporal=True, device="cpu",
                 extra_instances=()):
        self.width, self.height = width, height
        self.spatial, self.temporal = spatial, temporal
        self.device = dev = torch.device(device)
        pos, nrm, idx = mesh
        # an OBJ's normals are read as unit vectors (float32)
        nrm = np.asarray(nrm, np.float32)
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                               1e-30)
        self.scene = Scene(
            meshes=[ground_cube(),
                    Mesh(np.asarray(pos, np.float32), nrm.astype(np.float32),
                         np.asarray(idx, np.uint32))],
            materials=default_materials(),
            pos_scale=np.asarray(pos_scale, np.float32),
            extra_instances=tuple(extra_instances))
        self.camera = Camera(width=width, height=height)
        self.env = procedural_env(ENV_SIZE, dev)
        self.geom = upload_scene(self.scene, dev)
        s0 = self.env.sizes_host[0]
        mip0 = self.env.data[:6 * s0 * s0].cpu().reshape(6, s0, s0, 3)
        self.sh_coeffs = project_sh9(mip0).to(dev)
        mats = self.scene.instance_materials()
        rough_metals = np.array(mats.rough_metals, np.float32)
        for mesh_idx, value in (metallic or {}).items():
            for inst, mid in enumerate(self.scene.mesh_ids):
                if mid == int(mesh_idx):
                    rough_metals[inst, 1] = float(np.clip(value, 0.0, 1.0))
        self.materials = MaterialsDev(
            base_colors=torch.as_tensor(mats.base_colors, device=dev),
            rough_metals=torch.as_tensor(rough_metals, device=dev))
        # the diffuse wave and filter run where any instance is below 1
        self.diffuse = bool((rough_metals[:, 1] < 1.0).any())
        self.view_proj = self.camera.view_proj()
        self.proj_to_world = torch.linalg.inv(self.view_proj)
        self.eye = torch.as_tensor(self.camera.eye, dtype=torch.float32)
        self.jitter = halton_table(JITTER_TABLE)
        self.tracer = default_tracer(self.geom)

    def start_state(self, angle=0.0, frame=0) -> State:
        """A zero history; the previous WVPs those of angle 0, as the
        renderer's ``init_state``; the given angle and frame counter."""
        wvp = torch.einsum("ijk,kl->ijl", self.scene.worlds(0.0),
                           self.view_proj)
        return State(
            history=torch.zeros((self.height, self.width, 4),
                                dtype=torch.float16, device=self.device),
            prev_wvp=wvp.to(self.device), angle=np.float32(angle),
            frame=int(frame))

    def constants(self, frame, angle, prev_wvp) -> FrameConstants:
        dev = self.device
        worlds = self.scene.worlds(angle)
        wvp = torch.einsum("ijk,kl->ijl", worlds, self.view_proj)
        h2 = torch.as_tensor(self.jitter[frame % JITTER_TABLE])
        viewport = torch.tensor([float(self.width), float(self.height)])
        return FrameConstants(
            world_view_projs=wvp.to(dev),
            world_view_projs_prev=prev_wvp.to(dev, torch.float32),
            worlds=worlds.to(dev),
            world_its=self.scene.normal_matrices(worlds).to(dev),
            proj_to_world=self.proj_to_world.to(dev),
            eye=self.eye.to(dev),
            proj_bias=((h2 * 2.0 - 1.0) / viewport).to(dev),
            frame_index=torch.tensor(frame % RNG_FRAMES, device=dev),
            inv_worlds=torch.linalg.inv(worlds).to(dev))

    def step(self, state: State, dt: float):
        """One frame: (new state, tone-mapped frame (H, W, 3) float32)."""
        angle = advance(state.angle, dt)
        consts = self.constants(state.frame, angle, state.prev_wvp)
        tlas = build_tlas(self.geom.bounds, consts.worlds,
                          self.scene.mesh_ids, inv_worlds=consts.inv_worlds)
        out = ray_trace_pass(tlas, consts, self.materials, self.env,
                             self.sh_coeffs, self.width, self.height,
                             geom=self.geom, trace_fn=self.tracer,
                             diffuse=self.diffuse)
        history = state.history.to(self.device)
        accum = self._post_process(out, history)
        frame = tone_map(accum.to(torch.float32))
        return State(history=accum, prev_wvp=consts.world_view_projs,
                     angle=angle, frame=state.frame + 1), frame

    def _post_process(self, out, history):
        """Spatial filters, TAA and the f16 store of the history."""
        refl, diff = out["refl"], out["diff"]
        normal, depth = out["normal"], out["depth"]
        rough = out["rough_metal"][..., 0].contiguous()
        metal = out["rough_metal"][..., 1].contiguous()
        if self.spatial:
            flt = reflection_spatial_filter(refl, normal, rough, depth,
                                            self.width, self.height)
            if self.diffuse:
                flt = diffuse_spatial_filter(diff, flt, normal, metal, depth)
        else:
            comp = torch.where(metal[..., None] < 1.0, refl + diff, refl)
            flt = torch.cat([comp, normal[..., 3:4]], dim=-1)
        accum = (temporal_ss(flt, history, out["velocity"])
                 if self.temporal else flt)
        return accum.to(history.dtype)
