"""Multi-device rendering: the image in row bands, one band per device.

Torch port of raytracedggx_tpu/parallel/sharded.py.  The reference runs
its band step under ``shard_map`` over a 1-D mesh of one process's
devices; the port keeps that single-controller shape without a process
group: a "mesh" is a tuple of ``torch.device``, one per band, and one
process issues every band's work to its device.  Several bands may share
a device (``("cuda:0",) * 4`` runs four real bands on one card, with
their halos, edge masks and band-local filters; ``("cpu",) * 4`` on the
CPU).  Scene geometry, BVHs, the env probe and the materials live once
per distinct device; each band renders on its own.

The only cross-band dependency is the denoiser:

- ray tracing is pixel-independent, so each band *recomputes* its rows
  plus a ``halo`` of rows above and below instead of exchanging G-buffer
  channels; the RNG is keyed on global pixel ids (trace/raygen.py
  ``pixel_samples``), so overlapped rows are the same rays in every band;
- the TAA history cannot be recomputed, so its halo rows are copied from
  the neighbouring bands (``halo_exchange_rows``; a peer copy across
  cards).  The reference shifts them around a ``ppermute`` ring and masks
  the wrapped payloads on the first and last band; copying only from
  neighbours that exist gives the same rows;
- the spatial filters, the TAA 3x3 neighbourhood, the velocity dilation
  and the history reprojection read within the halo (32 rows by
  default).

Rows outside the global image keep the single-device semantics (zeros to
the filters and the tone map, the ``valid`` mask of ``_post_process``;
the history halo clamps at the image's top and bottom rows).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..engine import spans
from ..engine.renderer import Renderer, RenderState
from ..ops.ordering import make_block_order
from ..trace.env import EnvMap


def make_row_mesh(devices=None) -> tuple:
    """The row mesh: a tuple of ``torch.device``, one per band.  By
    default every CUDA device."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise RuntimeError("no CUDA device: pass the devices, e.g. "
                           "make_row_mesh(('cpu',) * 4)")
    return mesh


def halo_exchange_rows(bands, halo: int, edge: str = "zero"):
    """Pad each row band (Hb, W, ...) with ``halo`` rows of its
    neighbours: band i's top pad is band i - 1's last rows, its bottom pad
    band i + 1's first rows, copied to band i's device.  At the image's
    top and bottom the pad is zeros (edge="zero", HLSL OOB-load semantics
    for stencil taps) or the edge row repeated (edge="clamp", a clamping
    bilinear sampler: used for the TAA history, so band-local clamping
    equals whole-image clamping).  Returns the list of (Hb + 2 halo, W,
    ...) bands."""
    if edge not in ("zero", "clamp"):
        raise ValueError(f"edge={edge!r}")
    n, out = len(bands), []
    for i, x in enumerate(bands):
        if i > 0:
            top = bands[i - 1][-halo:].to(x.device)
        elif edge == "clamp":
            top = x[0:1].expand(halo, *x.shape[1:])
        else:
            top = x.new_zeros((halo,) + x.shape[1:])
        if i < n - 1:
            bot = bands[i + 1][:halo].to(x.device)
        elif edge == "clamp":
            bot = x[-1:].expand(halo, *x.shape[1:])
        else:
            bot = x.new_zeros((halo,) + x.shape[1:])
        out.append(torch.cat([top, x, bot], dim=0))
    return out


def _on(device):
    """``device`` made current while its band's work is issued, so that
    the kernels' wrappers launch into that card's stream on that card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _env_on(env: EnvMap, device) -> EnvMap:
    return EnvMap(*(x.to(device) if torch.is_tensor(x) else x for x in env))


class ShardedRenderer(Renderer):
    """Renderer whose frame runs as row bands, one per device of
    ``mesh`` (``make_row_mesh``).  The state's history is a tuple of n
    (H/n, W, 4) f16 bands, each on its band's device (the analog of the
    reference's row-sharded array); ``step`` returns the whole (H, W, 3)
    frame on the first device.  ``step_n`` is the loop of the band step,
    and ``async_compute`` does not apply."""

    def __init__(self, scene, mesh=None, halo: int = 32, **kw):
        self.mesh = make_row_mesh(mesh)
        super().__init__(scene, device=self.mesh[0], **kw)
        self.num_devices = n = len(self.mesh)
        cfg = self.config
        assert cfg.height % n == 0, \
            f"height {cfg.height} must divide by {n} devices"
        self.band = cfg.height // n
        self.halo = int(min(halo, self.band))
        # one renderer per distinct device: its geometry, scene BVH, env,
        # materials and staging ring serve every band on that device
        self._by_device = {self.device: self}
        for dev in self.mesh:
            if dev not in self._by_device:
                with _on(dev):
                    self._by_device[dev] = Renderer(
                        scene, camera=self.camera,
                        env=_env_on(self.env, dev), config=cfg, device=dev)
        # per-band screen-block ray order (band + halos), per device, and
        # each band's row mask: 0 on rows outside the image
        pad_h = self.band + 2 * self.halo
        self.band_ray_order = {
            dev: (make_block_order(cfg.width, pad_h, dev)
                  if self.traversal != "jax" else None)
            for dev in self._by_device}
        self._valid = []
        for idx, dev in enumerate(self.mesh):
            rows = idx * self.band - self.halo + torch.arange(pad_h)
            self._valid.append(((rows >= 0) & (rows < cfg.height)).to(
                torch.float32)[:, None, None].to(dev))

    def init_state(self) -> RenderState:
        wvp = torch.einsum("ijk,kl->ijl", self.scene.worlds(0.0),
                           self.view_proj)
        hist = tuple(torch.zeros((self.band, self.config.width, 4),
                                 dtype=torch.float16, device=dev)
                     for dev in self.mesh)
        return RenderState(history=hist, prev_wvp=wvp.to(self.device),
                           angle=np.float32(0.0), frame=0)

    def _band_step(self, state: RenderState, dt):
        """One frame as n bands: (state, frame bands)."""
        cfg = self.config
        halo, band, pad_h = self.halo, self.band, self.band + 2 * self.halo
        angle = self._advance(state.angle, dt)
        rows, slot = self._stage([state.frame], [angle])
        frame_consts = {}
        for dev, r in self._by_device.items():
            if r is self:
                dev_rows, dev_slot = rows, slot
            else:
                dev_rows, dev_slot = r._staging.take(1)
                dev_rows.copy_(rows)
            with _on(dev):
                row = r._staging.upload(dev_rows, dev_slot)[0]
                consts, inv_mats = r._layout.unpack(row)
                consts.world_view_projs_prev.copy_(state.prev_wvp)
                tlas, sw = r._refit(consts, inv_mats)
            frame_consts[dev] = (consts, tlas, sw)
        wave, filt = self._gates()
        hist_pad = halo_exchange_rows(state.history, halo, edge="clamp")
        accums, frames = [], []
        for idx, dev in enumerate(self.mesh):
            r = self._by_device[dev]
            consts, tlas, sw = frame_consts[dev]
            row0 = idx * band - halo
            with _on(dev):
                out = r._trace(consts, tlas, sw, wave, row0=row0,
                               band_height=pad_h,
                               ray_order=self.band_ray_order[dev])
                accum_pad, frame_pad = r._post_process(
                    out, hist_pad[idx], filt, valid=self._valid[idx],
                    full_size=(cfg.width, cfg.height), row0=row0)
            accums.append(accum_pad[halo:halo + band])
            frames.append(frame_pad[halo:halo + band])
        new_state = RenderState(
            history=tuple(accums),
            prev_wvp=frame_consts[self.device][0].world_view_projs,
            angle=angle, frame=state.frame + 1)
        return new_state, frames

    def step(self, state: RenderState, dt: float = 1 / 60):
        """One frame: (new_state, frame (H, W, 3) on the first device,
        None)."""
        new_state, frames = self._band_step(state, dt)
        frame = torch.cat([f.to(self.device) for f in frames], dim=0)
        spans.count_frames()
        return new_state, frame, None

    @property
    def captures(self) -> bool:
        return False

    def step_n(self, state: RenderState, num_frames: int,
               dt: float = 1 / 60):
        """num_frames band steps; returns (state, last_frame)."""
        if num_frames < 1:
            raise ValueError(f"num_frames={num_frames}: need at least 1")
        frame = None
        for _ in range(num_frames):
            state, frame, _ = self.step(state, dt)
        return state, frame

    def set_kernels(self, kernels: str):
        super().set_kernels(kernels)
        for r in getattr(self, "_by_device", {}).values():
            if r is not self:
                r.set_kernels(kernels)

    def set_metallic(self, mesh_idx: int, metallic: float):
        super().set_metallic(mesh_idx, metallic)
        for r in self._by_device.values():
            if r is not self:
                r.set_metallic(mesh_idx, metallic)
