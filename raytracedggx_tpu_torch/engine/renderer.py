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

The frame's small constants (matrices, jitter, the RNG's frame index,
the inverse worlds) are computed on the CPU, packed into one row of
bytes in pinned memory and copied to the device without waiting
(``_Layout``); a frame reads them from that device row.  The two runtime
gates of the reference (the diffuse wave and the diffuse filter, a
``lax.cond`` each) are decided on the host from the materials: open when
any instance has metallic < 1, where no pixel passing them makes both an
exact identity.  So on the kernel traversals a frame makes no host sync
and the host runs ahead of the card: ``run_frames`` bounds it to
``frames_in_flight`` frames.  ``step_n`` is the reference's one-dispatch
chunk (a ``lax.scan``): on a CUDA device it captures one frame into a
CUDA graph, over static buffers for the constants and the history, and
replays it once per frame after a device-to-device copy of that frame's
row of constants (all rows go up in one copy per call).  Its frames equal
``step``'s bit for bit.  The graph is captured again when something
baked into it changes: ``set_kernels``, a ``set_metallic`` that flips the
host's gate decision (otherwise the materials are updated in place), the
config, the state's shape.  ``async_compute`` (the reference's 'A'
toggle) runs ``step``'s refit (constants upload, TLAS, scene BVH) on a
second CUDA stream that the render waits on; the output is the same.

Everything per pixel runs on ``device``, the CUDA card unless the caller
passes ``device="cpu"`` (with no CUDA device the constructor raises; it
never falls back to the CPU).  The traversal kernels (K1, K4, K5), the
waves' transforms (XF) and the TAA (TS) run for CUDA tensors and their
plain versions for CPU tensors, whatever ``kernels`` says.  ``kernels`` picks only the spatial filters'
implementation, as in the reference (its 'V' toggle): "auto" and "cuda"
run kernels K2 and K3 (for CPU tensors their plain versions; "cuda"
requires a CUDA device), "xla" the plain torch passes on any device
(the reference's name for its direct stencils); ``set_kernels`` switches
it between frames.  ``emulate_formats`` round-trips the G-buffers and
the denoiser's targets through the reference's storage formats.  The
reference's off-by-default knobs keep its names and defaults:
``trace_slim`` (K1's slim mode, K1s, in every wave) acts on "wide" only
and raises ValueError on any other traversal; ``sort_dir_bits`` (3 or 6)
goes to ``ray_trace_pass``.  The reference's anchor sort key and its
profiling ablations are not ported (trace/raygen.py).  The row-band
renderer (parallel/sharded.py) runs this frame per band through the
hooks ``_trace(row0=, band_height=)`` and ``_post_process(valid=,
full_size=, row0=)``.  The reference's VMEM-budget fallback from "wide"
to per-mesh launches is a TPU residency limit and is dropped.
"""

from __future__ import annotations

import functools
import math
from collections import deque
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from .. import _precision  # noqa: F401  (float32 matmuls at full precision)
from ..bvh import build_tlas
from ..denoise import diffuse_spatial_filter, reflection_spatial_filter
from ..ops.fused import slim_uv, trace_tiles_instanced
from ..ops.ordering import make_block_order
from ..ops.scene_wide import (build_scene_wide, inverse_rows,
                              refit_scene_wide, trace_scene_wide_fused)
from ..ops.shade_cuda import shade_bounce
from ..ops.spatial_cuda import diffuse_pass, reflection_pass
from ..ops.temporal_cuda import temporal_ss
from ..ops.traverse_cuda import trace_scene_flat, trace_tiles_flat
from ..ops.wide import trace_scene4, trace_tiles4
from ..ops.xform_cuda import instance_xform
from ..post import tone_map
from ..scene.camera import Camera
from ..sh import project_sh9
from ..trace.env import EnvMap, procedural_env
from ..trace.geometry import upload_scene
from ..trace.raygen import (FrameConstants, MaterialsDev, default_tracer,
                            ray_trace_pass)
from ..utils.formats import quantize_f16, quantize_r11g11b10, quantize_unorm
from ..utils.halton import halton_table
from . import spans

ANIM_SPEED = 16.0 * math.pi / 180.0   # 16 deg/s (RayTracer.cpp:271)
JITTER_TABLE = 1024
RNG_FRAMES = 256                      # FrameIndex mod (RayTracer.cpp:295)
STAGING_SLOTS = 4                     # pinned constant rows in the ring:
                                      # the host runs at most this many
                                      # frames ahead of their copies
CAPTURE_WARMUP = 2                    # eager frames before a capture


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
    trace_slim: bool = False        # "wide": K1's slim mode (t, slot, inst;
                                    # u, v recomputed after the kernel)
    async_compute: bool = False     # 'A' toggle: step's refit on a second
                                    # CUDA stream (same output; no effect
                                    # on the CPU or on step_n)


class RenderState(NamedTuple):
    history: torch.Tensor       # (H, W, 4) f16 TAA accumulation (the
                                # reference's RGBA16F TemporalSSOut)
    prev_wvp: torch.Tensor      # (I, 4, 4) previous frame's WVPs
    angle: np.float32           # animation angle
    frame: int                  # absolute frame counter


class _Layout:
    """One frame's constants as a row of bytes: each field of
    ``FrameConstants`` (frame_index a 0-dim int64), then the (1 + I, 12)
    inverse-world rows of the scene BVH's refit, each at a 256-byte
    aligned offset.  A row is filled on the host and read on the device
    through typed views."""

    ALIGN = 256

    def __init__(self, num_inst: int):
        f32, mat = torch.float32, (num_inst, 4, 4)
        fields = [("world_view_projs", mat, f32),
                  ("world_view_projs_prev", mat, f32), ("worlds", mat, f32),
                  ("world_its", (num_inst, 3, 3), f32),
                  ("proj_to_world", (4, 4), f32), ("eye", (3,), f32),
                  ("proj_bias", (2,), f32),
                  ("frame_index", (), torch.int64),
                  ("inv_worlds", mat, f32),
                  ("inv_mats", (1 + num_inst, 12), f32)]
        self.fields, off = [], 0
        for name, shape, dtype in fields:
            n = math.prod(shape) * dtype.itemsize
            self.fields.append((name, off, n, shape, dtype))
            off += -(-n // self.ALIGN) * self.ALIGN
        self.nbytes = off

    def views(self, row) -> dict:
        """{field: typed view} of a (nbytes,) uint8 row."""
        return {name: row[off:off + n].view(dtype).view(shape)
                for name, off, n, shape, dtype in self.fields}

    def unpack(self, row):
        """(FrameConstants, inv_mats) viewing a row."""
        v = self.views(row)
        inv_mats = v.pop("inv_mats")
        return FrameConstants(**v), inv_mats


class _Staging:
    """Pinned host rows for the constants, in a ring of slots.  A slot is
    written again only after the copy that last read it has run (its
    event); without CUDA every take is a fresh CPU tensor, which the
    frame then reads in place."""

    def __init__(self, nbytes: int, device):
        self.nbytes, self.device = nbytes, device
        self.slots = [[None, None] for _ in range(STAGING_SLOTS)]
        self.next = 0

    def take(self, n: int):
        """((n, nbytes) uint8 host rows, slot or None)."""
        if self.device.type != "cuda":
            return torch.empty((n, self.nbytes), dtype=torch.uint8), None
        slot = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        buf, event = slot
        if event is not None:
            with spans.span("staging.wait"):
                event.synchronize()
        if buf is None or buf.shape[0] < n:
            buf = slot[0] = torch.empty((n, self.nbytes), dtype=torch.uint8,
                                        pin_memory=True)
        return buf[:n], slot

    def upload(self, rows, slot):
        """The rows on the device: a copy that does not wait, on the
        current stream, after which the slot's event is recorded."""
        if slot is None:
            return rows
        out = torch.empty(rows.shape, dtype=torch.uint8, device=self.device)
        out.copy_(rows, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record(torch.cuda.current_stream(self.device))
        return out


def launch_counters():
    """(kernel, wrapper, attribute) of each kernel wrapper's launch
    counter: K1's lean, slim (K1s) and fat (K1f) modes, K1s's epilogue
    K1e, then K2, K3, K4, K5, XF, the waves' per-instance transforms,
    TS, the TAA, and BS, the bounce waves' shading on K1's route."""
    k1 = trace_tiles_instanced
    return (("K1", k1, "launches"), ("K1s", k1, "launches_slim"),
            ("K1f", k1, "launches_fat"), ("K1e", slim_uv, "launches"),
            ("K2", reflection_pass, "launches"),
            ("K3", diffuse_pass, "launches"),
            ("K4", trace_tiles_flat, "launches"),
            ("K5", trace_tiles4, "launches"),
            ("XF", instance_xform, "launches"),
            ("TS", temporal_ss, "launches"),
            ("BS", shade_bounce, "launches"))


def launch_counts() -> dict:
    """{kernel: launches so far} of ``launch_counters``."""
    return {k: getattr(fn, attr) for k, fn, attr in launch_counters()}


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
        if self.traversal != "wide" and cfg.trace_slim:
            raise ValueError("trace_slim needs traversal='wide'")
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
        self.swide, self._k1_stats = None, None
        if self.traversal == "wide":
            # K1's counters, made before any frame is captured
            self._k1_stats = spans.k1_stats(dev)
            self.swide = build_scene_wide(self.geom, scene.mesh_ids,
                                          leaf_size=cfg.wide_leaf_size,
                                          device=dev)
        # screen-block order for the kernel traversals (warp coherence)
        self.ray_order = None
        if self.traversal != "jax":
            self.ray_order = make_block_order(cfg.width, cfg.height, dev)

        # SH projection of the env probe (first-frame TransformSH,
        # RayTracer.cpp:345-350, folded into construction)
        s0 = self.env.sizes_host[0]
        mip0 = self.env.data[:6 * s0 * s0].cpu().reshape(6, s0, s0, 3)
        self.sh_coeffs = project_sh9(mip0).to(dev)

        # the device materials are updated in place (a captured frame
        # reads them); the host keeps the metallics the gates read
        mats = scene.instance_materials()
        self.materials = MaterialsDev(
            base_colors=torch.as_tensor(mats.base_colors, device=dev),
            rough_metals=torch.as_tensor(mats.rough_metals, device=dev))
        self._metallic = np.array(mats.rough_metals[:, 1], np.float32)

        self.view_proj = self.camera.view_proj()            # CPU (4, 4)
        self.proj_to_world = torch.linalg.inv(self.view_proj)
        self.eye = torch.as_tensor(self.camera.eye, dtype=torch.float32)
        self.jitter = halton_table(JITTER_TABLE)
        self._viewport = torch.tensor([float(cfg.width), float(cfg.height)])
        self._layout = _Layout(len(scene.mesh_ids))
        self._staging = _Staging(self._layout.nbytes, dev)
        self._side = None          # async_compute's stream
        self._graph = None         # (key, CUDAGraph, frame output)
        self._static = self._static_hist = None
        # launches of each kernel in the captured frame (launch_counts'
        # keys), counted while it was captured
        self.capture_launches = None
        # for measurement: on the "wide" path, called as hook(sw, o, d,
        # t_min, t_max) with each wave's K1 inputs (sw the refitted scene
        # BVH) just before the wave is traced.  It fires when a frame is
        # built: at every step, but in step_n only while its graph is
        # warmed up and captured, not at replay
        self.trace_hook = None

    def init_state(self) -> RenderState:
        cfg = self.config
        wvp = torch.einsum("ijk,kl->ijl", self.scene.worlds(0.0),
                           self.view_proj)
        return RenderState(
            history=torch.zeros((cfg.height, cfg.width, 4),
                                dtype=torch.float16, device=self.device),
            prev_wvp=wvp.to(self.device), angle=np.float32(0.0), frame=0)

    # -- frame constants -----------------------------------------------

    @staticmethod
    def _advance(angle, dt):
        return np.float32(angle + np.float32(ANIM_SPEED) * np.float32(dt))

    def _fill(self, row, frame: int, angle, cam):
        """Compute one frame's constants on the CPU into a host row
        (world_view_projs_prev is left to the caller)."""
        if cam is None:
            view_proj, proj_to_world, eye = (self.view_proj,
                                             self.proj_to_world, self.eye)
        else:
            view_proj, proj_to_world, eye = (
                torch.as_tensor(x, dtype=torch.float32).cpu() for x in cam)
        v = self._layout.views(row)
        worlds = self.scene.worlds(angle)
        wvp = torch.einsum("ijk,kl->ijl", worlds, view_proj)
        h2 = torch.as_tensor(self.jitter[frame % JITTER_TABLE])
        v["world_view_projs"].copy_(wvp)
        v["worlds"].copy_(worlds)
        v["world_its"].copy_(self.scene.normal_matrices(worlds))
        v["proj_to_world"].copy_(proj_to_world)
        v["eye"].copy_(eye)
        v["proj_bias"].copy_((h2 * 2.0 - 1.0) / self._viewport)
        v["frame_index"].fill_(frame % RNG_FRAMES)
        v["inv_worlds"].copy_(torch.linalg.inv(worlds))
        v["inv_mats"].copy_(inverse_rows(worlds))
        return v

    def _stage(self, frames, angles, cam=None):
        """Host rows of consecutive frames (row i's previous WVPs are row
        i - 1's WVPs; row 0's are the caller's) and their staging slot."""
        rows, slot = self._staging.take(len(frames))
        prev = None
        for i, (frame, angle) in enumerate(zip(frames, angles)):
            v = self._fill(rows[i], frame, angle, cam)
            if prev is not None:
                v["world_view_projs_prev"].copy_(prev)
            prev = v["world_view_projs"]
        return rows, slot

    # -- the frame -------------------------------------------------------

    def _gates(self):
        """(diffuse wave, diffuse filter): open when any instance has
        metallic < 1, the filter's from the value the G-buffer stores
        (8 bits with emulate_formats).  Where no pixel passes the
        per-pixel gate, both are an exact identity."""
        metal = self._metallic
        wave = bool((metal < 1.0).any())
        if self.config.emulate_formats:       # quantize_unorm(metal, 8)
            q = np.float32(255.0)
            metal = np.round(np.clip(metal, 0.0, 1.0) * q) / q
        return wave, bool((metal < 1.0).any())

    def _refit(self, consts: FrameConstants, inv_mats):
        """The compute-queue work of a frame (RayTracer::
        UpdateAccelerationStructure): (TLAS, refitted scene BVH or None)."""
        spans.mark("refit", self.device)
        tlas = build_tlas(self.geom.bounds, consts.worlds,
                          self.scene.mesh_ids, inv_worlds=consts.inv_worlds)
        sw = None
        if self.traversal == "wide":
            sw = refit_scene_wide(self.swide, consts.worlds, inv_mats)
        return tlas, sw

    def _trace(self, consts, tlas, sw, diffuse: bool, row0: int = 0,
               band_height: int | None = None, ray_order=None):
        """The frame's three waves (``ray_trace_pass``); row0 /
        band_height and its screen-block ray_order for a row band."""
        cfg = self.config
        return ray_trace_pass(tlas, consts, self.materials, self.env,
                              self.sh_coeffs, cfg.width, cfg.height,
                              ray_order=(self.ray_order if ray_order is None
                                         else ray_order),
                              row0=row0, band_height=band_height,
                              bary_mode=cfg.bary_mode, geom=self.geom,
                              sort_secondary=(cfg.sort_secondary
                                              and self.traversal != "jax"),
                              sort_dir_bits=cfg.sort_dir_bits,
                              diffuse=diffuse,
                              mark=functools.partial(spans.mark,
                                                     device=self.device),
                              **self._tracer(sw))

    def _render(self, consts, tlas, sw, history):
        """Trace, denoise, accumulate, tone map: (accum, frame, out)."""
        wave, filt = self._gates()
        out = self._trace(consts, tlas, sw, wave)
        accum, frame = self._post_process(out, history, filt)
        return accum, frame, out

    def _post_process(self, out, history, filter_diffuse=True, valid=None,
                      full_size=None, row0=0):
        """Denoise + accumulate + tone map.  Returns (accum, frame).
        valid: an optional (H, 1, 1) row mask of a row band, 0 on rows
        outside the image, which then read as zeros (the reference's OOB
        loads) to the filters and the tone map; full_size: the image's
        (W, H) and row0 the band's first image row, for the TAA
        reprojection of a band (``temporal_ss``)."""
        spans.mark("spatial", self.device)
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
        if valid is not None:
            refl, diff = refl * valid, diff * valid
            normal, rough_metal = normal * valid, rough_metal * valid
            velocity, depth = velocity * valid, depth * valid[..., 0]
        rough = rough_metal[..., 0].contiguous()
        metal = rough_metal[..., 1].contiguous()
        if cfg.spatial:
            flt_rfl = reflection_spatial_filter(refl, normal, rough, depth,
                                                cfg.width, cfg.height,
                                                impl=self.impl)
            # the diffuse filter's per-pixel gate is hit & (metal < 1)
            # (CSSpatial_H_Diff.hlsl:35); where no pixel passes it both
            # passes are an exact identity on flt_rfl, so the host's gate
            # (Renderer._gates) skips them when no instance can pass it
            if filter_diffuse:
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
        spans.mark("taa", self.device)
        accum = (temporal_ss(flt_dff, history, velocity, full_size, row0)
                 if cfg.temporal else flt_dff)
        if cfg.emulate_formats:
            accum = quantize_f16(accum)
        if valid is not None:
            accum = accum * valid
        # stored at the history dtype (f16); the tone map reads the same
        # stored values
        accum = accum.to(history.dtype)
        spans.mark("tonemap", self.device)
        frame = tone_map(accum.to(torch.float32))
        spans.mark("end", self.device)
        return accum, frame

    def _tracer(self, sw):
        """The frame's traversal: trace_fused (K1, or K1s with trace_slim,
        over the refitted scene BVH sw) or trace_fn (per-mesh, in each
        instance's object space).  The fused trace numbers its calls, the
        frame's waves in order, and adds each wave's K1 work to its row of
        ``spans``' counters."""
        if self.traversal == "wide":
            hook, slim = self.trace_hook, self.config.trace_slim
            rows = iter(self._k1_stats)

            def trace(o, d, t_min, t_max):
                if hook is not None:
                    hook(sw, o, d, t_min, t_max)
                return trace_scene_wide_fused(sw, o, d, t_min, t_max,
                                              slim=slim, stats=next(rows))
            return dict(trace_fused=trace)
        if self.traversal == "jax":
            return dict(trace_fn=default_tracer(self.geom))
        geom = self.geom
        if self.traversal == "pallas":
            return dict(trace_fn=lambda tlas, o, d, t_min, t_max:
                        trace_scene_flat(geom.flat, tlas, o, d, t_min, t_max))
        return dict(trace_fn=lambda tlas, o, d, t_min, t_max:
                    trace_scene4(geom.wide, tlas, o, d, t_min, t_max))

    # -- the host loop -------------------------------------------------

    @spans.spanned("step")
    def step(self, state: RenderState, dt: float = 1 / 60, cam=None):
        """One frame: returns (new_state, frame (H, W, 3), aux dict).  On
        the kernel traversals it makes no host sync: the returned tensors
        are ready when the stream reaches them.

        cam: optional (view_proj (4, 4), proj_to_world (4, 4), eye (3,))
        host arrays overriding the construction camera for this frame
        (``OrbitController.arrays``).  With ``async_compute`` on a CUDA
        device the refit runs on a second stream (the reference's
        compute-queue submission); the frame is the same."""
        angle = self._advance(state.angle, dt)
        rows, slot = self._stage([state.frame], [angle], cam)
        if self.config.async_compute and self.device.type == "cuda":
            main = torch.cuda.current_stream(self.device)
            if self._side is None:
                self._side = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._side):
                row = self._staging.upload(rows, slot)[0]
                consts, inv_mats = self._layout.unpack(row)
                tlas, sw = self._refit(consts, inv_mats)
            main.wait_stream(self._side)
            # made on the side stream, read on the main one
            for t in (row, tlas.aabb_min, tlas.aabb_max,
                      *((sw.nodes,) if sw is not None else ())):
                t.record_stream(main)
        else:
            row = self._staging.upload(rows, slot)[0]
            consts, inv_mats = self._layout.unpack(row)
            tlas, sw = self._refit(consts, inv_mats)
        consts.world_view_projs_prev.copy_(state.prev_wvp)
        accum, frame, out = self._render(consts, tlas, sw, state.history)
        spans.count_frames()
        new_state = RenderState(history=accum,
                                prev_wvp=consts.world_view_projs,
                                angle=angle, frame=state.frame + 1)
        return new_state, frame, dict(out, accum=accum)

    @property
    def captures(self) -> bool:
        """Whether step_n replays a captured frame: on a CUDA device with a
        kernel traversal.  The "jax" traversal loops while any ray is
        active, a host decision per step that a graph cannot hold."""
        return self.device.type == "cuda" and self.traversal != "jax"

    def _graph_key(self, state):
        return (self.kernels, self._gates(),
                replace(self.config, async_compute=False),
                tuple(state.history.shape), state.history.dtype,
                tuple(state.prev_wvp.shape))

    def _captured_frame(self):
        """The frame step_n captures: constants from the static row,
        history from the static history, which it overwrites."""
        consts, inv_mats = self._layout.unpack(self._static)
        tlas, sw = self._refit(consts, inv_mats)
        accum, frame, _ = self._render(consts, tlas, sw, self._static_hist)
        self._static_hist.copy_(accum)
        return frame

    @spans.spanned("capture")
    def _capture(self, key, row0, history):
        """Warm the frame up on a side stream, then capture one frame into
        a CUDA graph over the static buffers.  Raises if the capture
        fails; nothing falls back to the eager loop.  The warm-up frames
        count as frames run (``spans.count_frames``), the capture not."""
        self._graph = None
        dev = self.device
        self._static = row0.clone()
        self._static_hist = history.clone()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(CAPTURE_WARMUP):
                self._captured_frame()
                spans.count_frames()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(graph):
            frame = self._captured_frame()
        self.capture_launches = {k: n - before[k]
                                 for k, n in launch_counts().items()}
        self._graph = (key, graph, frame)

    @spans.spanned("step_n")
    def step_n(self, state: RenderState, num_frames: int,
               dt: float = 1 / 60):
        """num_frames frames; returns (state, last_frame).  Where
        ``captures`` holds, one captured frame replayed num_frames times
        (the reference's one-dispatch ``lax.scan``): every frame's
        constants are computed on the host and copied up in one go, and
        each replay follows a device-to-device copy of its row into the
        static constants.  The frames equal num_frames ``step`` calls bit
        for bit (the kernels and their inputs are the same).  Elsewhere
        (the CPU, the "jax" traversal) it is the loop of ``step``.
        ``async_compute`` does not apply (the reference's chunk fuses the
        refit too).  ``trace_hook`` and the kernels' launch counters fire
        while the frame is warmed up and captured, not at replay:
        ``capture_launches`` holds the captured frame's launches."""
        if num_frames < 1:
            raise ValueError(f"num_frames={num_frames}: need at least 1")
        if not self.captures:
            frame = None
            for _ in range(num_frames):
                state, frame, _ = self.step(state, dt)
            return state, frame
        frames = [state.frame + i for i in range(num_frames)]
        angles, angle = [], state.angle
        for _ in frames:
            angle = self._advance(angle, dt)
            angles.append(angle)
        with spans.span("step_n.stage"):
            staged = self._stage(frames, angles)
        with spans.span("step_n.upload"):
            rows = self._staging.upload(*staged)
            self._layout.views(rows[0])["world_view_projs_prev"].copy_(
                state.prev_wvp)
        key = self._graph_key(state)
        if self._graph is None or self._graph[0] != key:
            self._capture(key, rows[0], state.history)
        _, graph, frame = self._graph
        self._static_hist.copy_(state.history)
        for i in range(num_frames):
            with spans.span("step_n.replay"):
                self._static.copy_(rows[i])
                graph.replay()
            spans.count_frames()
        with spans.span("step_n.clone"):
            new_state = RenderState(
                history=self._static_hist.clone(),
                prev_wvp=self._layout.views(rows[-1])["world_view_projs"],
                angle=angles[-1], frame=state.frame + num_frames)
            frame = frame.clone()
        return new_state, frame

    def set_kernels(self, kernels: str):
        """The reference's 'V' hotkey (RayTracedGGX.cpp:391-393): switch
        the spatial filters between kernels K2 / K3 ("auto", "cuda") and
        the plain torch passes ("xla") from the next frame on; a no-op
        when unchanged.  The traversal is not touched.  step_n captures
        its frame again at its next call, as the reference drops its
        compiled programs."""
        if kernels == self.kernels:
            return
        if kernels not in ("auto", "xla", "cuda"):
            raise ValueError(f"kernels={kernels!r}")
        if kernels == "cuda" and self.device.type != "cuda":
            raise ValueError("kernels='cuda' needs a CUDA device")
        self.kernels = kernels

    def set_async_compute(self, on: bool):
        """The reference's 'A' hotkey (RayTracedGGX.cpp:394-396): run
        step's refit on a second CUDA stream, or on the frame's own."""
        self.config = replace(self.config, async_compute=bool(on))

    @property
    def impl(self) -> str:
        """The spatial filters' impl: "xla" (plain passes) or "cuda"."""
        return "xla" if self.kernels == "xla" else "cuda"

    def set_metallic(self, mesh_idx: int, metallic: float):
        """RayTracer::SetMetallic (RayTracer.cpp:243-247): every instance
        of the mesh updates (instances share mesh materials), in place on
        the device, from the next frame on (a captured frame reads the
        same tensor; step_n captures again only when the gates flip)."""
        value = float(np.clip(metallic, 0.0, 1.0))
        for inst, mid in enumerate(self.scene.mesh_ids):
            if mid == mesh_idx:
                self.materials.rough_metals[inst, 1] = value
                self._metallic[inst] = value

    def run_frames(self, num_frames: int, dt: float = 1 / 60,
                   state: RenderState | None = None, frames_in_flight=3):
        """Render num_frames frames with at most ``frames_in_flight``
        outstanding on the card (the reference's FrameCount=3 fencing,
        RayTracedGGX.cpp:684-717): once frame i is issued, the host
        waits for frame i - frames_in_flight to finish; at the end, for
        the last one.  On the CPU every frame is done when step returns."""
        state = state or self.init_state()
        cuda = self.device.type == "cuda"
        pending, last = deque(), None
        for _ in range(num_frames):
            state, last, _ = self.step(state, dt)
            if cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                pending.append(done)
                if len(pending) > frames_in_flight:
                    pending.popleft().synchronize()
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return state, last
