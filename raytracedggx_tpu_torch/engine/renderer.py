"""Frame orchestration: the RayTracedGGX app loop, one frame per ``step``.

Torch port of raytracedggx_tpu/engine/renderer.py.  ``traversal``:
"wide" (and "auto") is the fused instanced traversal, kernel K1, one
launch per wave; "pallas" (kernel K4, a binary tree) and "pallas4"
(kernel K5, 4-wide with a stack) trace each instance's mesh BVH in its
object space, one launch per instance and wave; "jax" is the plain
wavefront traversal over the per-mesh LBVHs.  The per-mesh paths shade
from the hit triangle's vertices, as the reference's ``trace_fn`` route
does; ``bary_mode="ndc"`` takes that route on every traversal.
Per frame (RayTracer::UpdateFrame, RayTracer.cpp:250-305):

- advance the model rotation 16 deg/s * dt (RayTracer.cpp:270-272);
- Halton sub-pixel jitter, projBias = (h*2-1)/viewport (:253-258);
- rebuild the instance matrices, keep the previous frame's WVPs;
- refit the TLAS and the instanced scene BVH (:326-341);
- ray trace (primary, reflection, gated diffuse wave) -> spatial H/V
  reflection + diffuse filters -> temporal accumulate (f16 history) ->
  tone map.

The small per-frame matrices are computed on the CPU and copied to the
device; everything per pixel runs on ``device``, the CUDA card unless
the caller passes ``device="cpu"`` (with no CUDA device the constructor
raises; it never falls back to the CPU).  The traversal kernels (K1, K4,
K5) run for CUDA tensors and their plain versions for CPU tensors,
whatever ``kernels`` says.  ``kernels`` picks only the spatial filters'
implementation, as in the reference (its 'V' toggle): "auto" and "cuda"
run kernels K2 and K3 (for CPU tensors their plain versions; "cuda"
requires a CUDA device), "xla" the plain torch passes on any device
(the reference's name for its direct stencils); ``set_kernels`` switches
it between frames.  ``emulate_formats`` round-trips the G-buffers and
the denoiser's targets through the reference's storage formats.  The
reference's off-by-default knobs keep its names and defaults:
``trace_slim`` (K1's slim mode, K1s, in every wave) and ``sort_anchor``
(an anchor cut of that many boxes per mesh, whose per-ray id joins the
bounce sort key) act on "wide" only and raise ValueError on any other
traversal; ``sort_dir_bits`` (3 or 6) and the ``dbg_*`` ablations go to
``ray_trace_pass``.  Not
ported yet: the reference's ``async_compute``, the ``cam`` override of
``step``, the sharded ``valid`` mask, and ``step_n`` as one captured
program (here a Python loop).  The reference's
VMEM-budget fallback from "wide" to per-mesh launches is a TPU residency
limit and is dropped.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..bvh import build_tlas
from ..denoise import (diffuse_spatial_filter, reflection_spatial_filter,
                       temporal_ss)
from ..ops.ordering import make_block_order
from ..ops.scene_wide import (anchor_bits, anchor_ids_scene,
                              build_scene_wide, refit_scene_wide,
                              trace_scene_wide_fused)
from ..ops.traverse_cuda import trace_scene_flat
from ..ops.wide import trace_scene4
from ..post import tone_map
from ..scene.camera import Camera
from ..sh import project_sh9
from ..trace.env import EnvMap, procedural_env
from ..trace.geometry import upload_scene
from ..trace.raygen import (FrameConstants, MaterialsDev, default_tracer,
                            ray_trace_pass)
from ..utils.formats import quantize_f16, quantize_r11g11b10, quantize_unorm
from ..utils.halton import halton_table

ANIM_SPEED = 16.0 * math.pi / 180.0   # 16 deg/s (RayTracer.cpp:271)
JITTER_TABLE = 1024
RNG_FRAMES = 256                      # FrameIndex mod (RayTracer.cpp:295)


@dataclass(frozen=True)
class RenderConfig:
    width: int = 1280
    height: int = 720
    bary_mode: str = "direct"       # or "ndc" (reference reconstruction)
    spatial: bool = True            # spatial filters on/off
    temporal: bool = True           # TAA accumulate on/off
    emulate_formats: bool = False   # round-trip reference storage precision
    kernels: str = "auto"           # spatial filters: "auto" | "cuda"
                                    # (K2, K3) | "xla" (plain passes)
    traversal: str = "auto"         # "auto" (= "wide", K1) | "wide" |
                                    # "pallas4" (K5) | "pallas" (K4) | "jax"
    leaf_size: int = 8              # per-mesh tree leaf size (K4, K5)
    # scene BVH leaf size (stream slots).  The reference's L64 was its TPU
    # kbench's best; on an NVIDIA H100 80GB HBM3 (700 W) K1 itself costs,
    # in ms on kbench's 1280x720 primary / reflection sets in one run
    # (scripts/kbench.py rows k1, k1_l16, k1_l64): L8 0.3173 / 0.2335,
    # L16 0.4084 / 0.2626, L64 0.7128 / 0.4448
    wide_leaf_size: int = 8
    sort_secondary: bool = True     # dead|octant|Morton order for bounce
                                    # waves (kernel traversals only)
    sort_dir_bits: int = 3          # direction-class bits of that key (3 =
                                    # octant; 6 = ~30 degree cones)
    sort_anchor: int = 0            # "wide": a ~K-box cut per mesh whose
                                    # nearest-entry id joins the key after
                                    # the direction class (0: off)
    trace_slim: bool = False        # "wide": K1's slim mode (t, slot, inst;
                                    # u, v recomputed after the kernel)
    dbg_no_refl_trace: bool = False       # ablations of the reflection
    dbg_no_secondary_shade: bool = False  # wave (trace/raygen.py)
    dbg_env_mode: str = "full"            # "no_env" | "bilinear"
    dbg_miss_lod: float = 0.0             # env LOD of its misses


class RenderState(NamedTuple):
    history: torch.Tensor       # (H, W, 4) f16 TAA accumulation (the
                                # reference's RGBA16F TemporalSSOut)
    prev_wvp: torch.Tensor      # (I, 4, 4) previous frame's WVPs
    angle: np.float32           # animation angle
    frame: int                  # absolute frame counter


class Renderer:
    def __init__(self, scene, camera: Camera | None = None,
                 env: EnvMap | None = None,
                 config: RenderConfig | None = None, device="cuda"):
        self.config = cfg = config or RenderConfig()
        self.device = dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to "
                               "render with the plain torch versions")
        self.traversal = "wide" if cfg.traversal == "auto" else cfg.traversal
        if self.traversal not in ("wide", "pallas4", "pallas", "jax"):
            raise ValueError(f"traversal={cfg.traversal!r}")
        if self.traversal != "wide" and (cfg.trace_slim or cfg.sort_anchor):
            raise ValueError("trace_slim and sort_anchor need "
                             "traversal='wide'")
        if cfg.sort_dir_bits not in (3, 6):
            raise ValueError(f"sort_dir_bits={cfg.sort_dir_bits!r}")
        self.kernels = None
        self.set_kernels(cfg.kernels)
        self.scene = scene
        self.camera = camera or Camera(width=cfg.width, height=cfg.height)
        self.camera.width, self.camera.height = cfg.width, cfg.height
        self.env = env if env is not None else procedural_env(64, dev)
        self.geom = upload_scene(scene, dev, traversal=self.traversal,
                                 leaf_size=cfg.leaf_size)
        self.swide, self._anchor_bits = None, 0
        if self.traversal == "wide":
            self.swide = build_scene_wide(self.geom, scene.mesh_ids,
                                          leaf_size=cfg.wide_leaf_size,
                                          device=dev,
                                          anchor_cut=cfg.sort_anchor)
            if cfg.sort_anchor:
                self._anchor_bits = anchor_bits(self.swide)
        # screen-block order for the kernel traversals (warp coherence)
        self.ray_order = None
        if self.traversal != "jax":
            self.ray_order = make_block_order(cfg.width, cfg.height, dev)

        # SH projection of the env probe (first-frame TransformSH,
        # RayTracer.cpp:345-350, folded into construction)
        s0 = int(self.env.sizes[0])
        mip0 = self.env.data[:6 * s0 * s0].cpu().reshape(6, s0, s0, 3)
        self.sh_coeffs = project_sh9(mip0).to(dev)

        mats = scene.instance_materials()
        self.materials = MaterialsDev(
            base_colors=torch.as_tensor(mats.base_colors, device=dev),
            rough_metals=torch.as_tensor(mats.rough_metals, device=dev))

        self.view_proj = self.camera.view_proj()            # CPU (4, 4)
        self.proj_to_world = torch.linalg.inv(self.view_proj)
        self.eye = torch.as_tensor(self.camera.eye, dtype=torch.float32)
        self.jitter = halton_table(JITTER_TABLE)
        # for measurement: on the "wide" path, called as hook(sw, o, d,
        # t_min, t_max) with each wave's K1 inputs (sw the refitted scene
        # BVH) just before the wave is traced
        self.trace_hook = None

    def init_state(self) -> RenderState:
        cfg = self.config
        wvp = torch.einsum("ijk,kl->ijl", self.scene.worlds(0.0),
                           self.view_proj)
        return RenderState(
            history=torch.zeros((cfg.height, cfg.width, 4),
                                dtype=torch.float16, device=self.device),
            prev_wvp=wvp.to(self.device), angle=np.float32(0.0), frame=0)

    def _constants(self, state: RenderState, angle):
        """Frame constants, computed on the CPU and moved to the device."""
        cfg = self.config
        worlds = self.scene.worlds(angle)
        wvp = torch.einsum("ijk,kl->ijl", worlds, self.view_proj)
        h2 = torch.as_tensor(self.jitter[state.frame % JITTER_TABLE])
        bias = (h2 * 2.0 - 1.0) / torch.tensor([float(cfg.width),
                                                float(cfg.height)])
        dev = self.device
        consts = FrameConstants(
            world_view_projs=wvp.to(dev),
            world_view_projs_prev=state.prev_wvp,
            worlds=worlds.to(dev),
            world_its=self.scene.normal_matrices(worlds).to(dev),
            proj_to_world=self.proj_to_world.to(dev),
            eye=self.eye.to(dev),
            proj_bias=bias.to(dev),
            frame_index=state.frame % RNG_FRAMES,
            inv_worlds=torch.linalg.inv(worlds).to(dev))
        return consts

    def _post_process(self, out, history):
        """Denoise + accumulate + tone map.  Returns (accum, frame)."""
        cfg = self.config
        refl, diff = out["refl"], out["diff"]
        normal, depth = out["normal"], out["depth"]
        rough_metal, velocity = out["rough_metal"], out["velocity"]
        if cfg.emulate_formats:
            refl = quantize_r11g11b10(refl)
            diff = quantize_r11g11b10(diff)
            normal = torch.cat([quantize_unorm(normal[..., :3], 10),
                                quantize_unorm(normal[..., 3:4], 2)], dim=-1)
            rough_metal = quantize_unorm(rough_metal, 8)
            velocity = quantize_f16(velocity)
        rough = rough_metal[..., 0].contiguous()
        metal = rough_metal[..., 1].contiguous()
        if cfg.spatial:
            flt_rfl = reflection_spatial_filter(refl, normal, rough, depth,
                                                cfg.width, cfg.height,
                                                impl=self.impl)
            # the diffuse filter's per-pixel gate is hit & (metal < 1)
            # (CSSpatial_H_Diff.hlsl:35); where no pixel passes it both
            # passes are an exact identity on flt_rfl, so they are skipped
            if bool(((normal[..., 3] > 0.0) & (metal < 1.0)).any()):
                flt_dff = diffuse_spatial_filter(diff, flt_rfl, normal,
                                                 metal, depth,
                                                 impl=self.impl)
            else:
                flt_dff = flt_rfl
        else:
            hit = normal[..., 3:4]
            comp = torch.where(metal[..., None] < 1.0, refl + diff, refl)
            flt_dff = torch.cat([comp, hit], dim=-1)
        if cfg.emulate_formats:
            flt_dff = quantize_f16(flt_dff)
        accum = (temporal_ss(flt_dff, history, velocity)
                 if cfg.temporal else flt_dff)
        if cfg.emulate_formats:
            accum = quantize_f16(accum)
        # stored at the history dtype (f16); the tone map reads the same
        # stored values
        accum = accum.to(history.dtype)
        return accum, tone_map(accum.to(torch.float32))

    def step(self, state: RenderState, dt: float = 1 / 60):
        """One frame: returns (new_state, frame (H, W, 3), aux dict)."""
        cfg = self.config
        angle = np.float32(state.angle
                           + np.float32(ANIM_SPEED) * np.float32(dt))
        consts = self._constants(state, angle)
        tlas = build_tlas(self.geom.bounds, consts.worlds,
                          self.scene.mesh_ids, inv_worlds=consts.inv_worlds)
        out = ray_trace_pass(tlas, consts, self.materials, self.env,
                             self.sh_coeffs, cfg.width, cfg.height,
                             ray_order=self.ray_order,
                             bary_mode=cfg.bary_mode, geom=self.geom,
                             sort_secondary=(cfg.sort_secondary
                                             and self.traversal != "jax"),
                             sort_dir_bits=cfg.sort_dir_bits,
                             dbg_no_refl_trace=cfg.dbg_no_refl_trace,
                             dbg_no_secondary_shade=(
                                 cfg.dbg_no_secondary_shade),
                             dbg_env_mode=cfg.dbg_env_mode,
                             dbg_miss_lod=cfg.dbg_miss_lod,
                             **self._tracer(consts))
        accum, frame = self._post_process(out, state.history)
        new_state = RenderState(history=accum,
                                prev_wvp=consts.world_view_projs,
                                angle=angle, frame=state.frame + 1)
        return new_state, frame, dict(out, accum=accum)

    def _tracer(self, consts):
        """The frame's traversal: trace_fused (K1, or K1s with trace_slim,
        over the refitted scene BVH, with the anchor ids of sort_anchor) or
        trace_fn (per-mesh, in each instance's object space)."""
        if self.traversal == "wide":
            sw = refit_scene_wide(self.swide, consts.worlds)
            hook, slim = self.trace_hook, self.config.trace_slim

            def trace(o, d, t_min, t_max):
                if hook is not None:
                    hook(sw, o, d, t_min, t_max)
                return trace_scene_wide_fused(sw, o, d, t_min, t_max,
                                              slim=slim)
            out = dict(trace_fused=trace)
            if self._anchor_bits:
                out.update(anchor_fn=lambda o, d: anchor_ids_scene(sw, o, d),
                           anchor_bits=self._anchor_bits)
            return out
        if self.traversal == "jax":
            return dict(trace_fn=default_tracer(self.geom))
        geom = self.geom
        if self.traversal == "pallas":
            return dict(trace_fn=lambda tlas, o, d, t_min, t_max:
                        trace_scene_flat(geom.flat, tlas, o, d, t_min, t_max))
        return dict(trace_fn=lambda tlas, o, d, t_min, t_max:
                    trace_scene4(geom.wide, tlas, o, d, t_min, t_max))

    def step_n(self, state: RenderState, num_frames: int,
               dt: float = 1 / 60):
        """num_frames frames; returns (state, last_frame)."""
        frame = None
        for _ in range(num_frames):
            state, frame, _ = self.step(state, dt)
        return state, frame

    def set_kernels(self, kernels: str):
        """The reference's 'V' hotkey (RayTracedGGX.cpp:391-393): switch
        the spatial filters between kernels K2 / K3 ("auto", "cuda") and
        the plain torch passes ("xla") from the next frame on; a no-op
        when unchanged.  The port runs eagerly, so there is no compiled
        frame to drop.  The traversal is not touched."""
        if kernels == self.kernels:
            return
        if kernels not in ("auto", "xla", "cuda"):
            raise ValueError(f"kernels={kernels!r}")
        if kernels == "cuda" and self.device.type != "cuda":
            raise ValueError("kernels='cuda' needs a CUDA device")
        self.kernels = kernels

    @property
    def impl(self) -> str:
        """The spatial filters' impl: "xla" (plain passes) or "cuda"."""
        return "xla" if self.kernels == "xla" else "cuda"

    def set_metallic(self, mesh_idx: int, metallic: float):
        """RayTracer::SetMetallic (RayTracer.cpp:243-247): every instance
        of the mesh updates (instances share mesh materials)."""
        rm = self.materials.rough_metals.clone()
        for inst, mid in enumerate(self.scene.mesh_ids):
            if mid == mesh_idx:
                rm[inst, 1] = float(np.clip(metallic, 0.0, 1.0))
        self.materials = self.materials._replace(rough_metals=rm)

    def run_frames(self, num_frames: int, dt: float = 1 / 60,
                   state: RenderState | None = None):
        """Render num_frames frames and wait for the last one."""
        state, last = self.step_n(state or self.init_state(), num_frames, dt)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return state, last
