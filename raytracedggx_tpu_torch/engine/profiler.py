"""Profiling hooks: the PIX-marker / GPU-timestamp analog.

Counterpart of raytracedggx_tpu/engine/profiler.py.  ``trace_frames``
records a ``torch.profiler`` trace (CPU and, on a CUDA machine, device
activity) of the frames rendered inside it and writes it as a Chrome
trace (``trace.json``, viewable in Perfetto or chrome://tracing);
``time_stages`` times one frame's stages, as the frame runs them, between
CUDA events (on the CPU, the host clock).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def trace_frames(logdir: str | None = None):
    """Profile the block; write ``<logdir>/trace.json`` on leaving it.
    logdir defaults to ``rtggx-trace`` under the temporary directory."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "rtggx-trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _timed(device, fn):
    """(fn()'s result, ms of a second run of fn): between CUDA events on a
    CUDA device, on the host clock elsewhere."""
    fn()                                        # warm-up
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def time_stages(renderer, state, dt: float = 1 / 60) -> dict:
    """Per-stage ms of one frame from ``state``, each stage run as the
    renderer's frame runs it (its traversal, its gates, its filters):
    ``primary_ms`` (the primary wave), ``trace_total_ms`` (all three
    waves), ``spatial_ms`` (the reflection filter and, when its gate is
    open, the diffuse filter) and ``temporal_tonemap_ms``."""
    from ..denoise import (diffuse_spatial_filter, reflection_spatial_filter,
                           temporal_ss)
    from ..post import tone_map
    from ..trace.raygen import primary_surface

    r, cfg, dev = renderer, renderer.config, renderer.device
    rows, slot = r._stage([state.frame], [r._advance(state.angle, dt)])
    consts, inv_mats = r._layout.unpack(r._staging.upload(rows, slot)[0])
    consts.world_view_projs_prev.copy_(state.prev_wvp)
    tlas, sw = r._refit(consts, inv_mats)
    wave, filt = r._gates()
    tracer = r._tracer(sw)
    times = {}
    _, times["primary_ms"] = _timed(dev, lambda: primary_surface(
        consts, r.materials, cfg.width, cfg.height,
        tracer.get("trace_fused"), r.ray_order, cfg.bary_mode,
        tracer.get("trace_fn"), r.geom, tlas))
    out, times["trace_total_ms"] = _timed(
        dev, lambda: r._trace(consts, tlas, sw, wave))
    normal, depth = out["normal"], out["depth"]
    rough = out["rough_metal"][..., 0].contiguous()
    metal = out["rough_metal"][..., 1].contiguous()

    def spatial():
        flt = reflection_spatial_filter(out["refl"], normal, rough, depth,
                                        cfg.width, cfg.height, impl=r.impl)
        if filt:
            flt = diffuse_spatial_filter(out["diff"], flt, normal, metal,
                                         depth, impl=r.impl)
        return flt

    flt, times["spatial_ms"] = _timed(dev, spatial)
    _, times["temporal_tonemap_ms"] = _timed(dev, lambda: tone_map(
        temporal_ss(flt, state.history, out["velocity"])))
    return times
