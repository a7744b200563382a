"""The traced stretch: ``torch.profiler`` over a steady run of the same
captured frame loop, after the measured window has closed, and what the
per-layer readers read from it.

Device busy time is the union of the device operations' intervals (the
port's ``scripts/kprofile.py`` arithmetic, copied); the idle share is one
minus busy over the stretch's host wall.  The breakdown names the
device operations that took most time and the longest idle gaps by the
innermost host operation running at the gap's middle.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from harness import frame_loop, sync

TOP = 10


@dataclass
class Trace:
    """What a per-layer reader reads (``metrics/<name>.py``)."""
    frames: int                 # frames in the traced stretch
    wall_s: float               # its host wall, issue to last host read
    device_ops: list            # (name, start_us, end_us) per operation
    busy_s: float               # union of the operations' intervals
    host_ms_per_frame: float    # inside step_n, over the measured window
    live_rays: dict             # per wave, from the warm-up frame
    triangles: dict             # per mesh
    width: int
    height: int
    peaks: dict                 # peaks.json
    roofline: object = None     # kernel -> its roofline module
    gaps: list = field(default_factory=list)   # (host op, seconds)

    def kernel_s(self, patterns) -> tuple:
        """(seconds, launches) of device operations whose name holds one
        of ``patterns``."""
        ops = [(a, b) for name, a, b in self.device_ops
               if any(p in name for p in patterns)]
        return sum(b - a for a, b in ops) / 1e6, len(ops)


def union_s(intervals) -> float:
    """Length of the union of (start_us, end_us) intervals, in seconds."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6


def idle_gaps(device_ops, host_ops):
    """[(name, seconds)] of the idle gaps between device operations, each
    named by the shortest host operation covering its middle."""
    merged = []
    for a, b in sorted((a, b) for _, a, b in device_ops):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    out = []
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = (end + start) / 2
        cover = [(b - a, name) for name, a, b in host_ops if a <= mid <= b]
        out.append((min(cover)[1] if cover else "(no host op)",
                    (start - end) / 1e6))
    return sorted(out, key=lambda g: -g[1])


def profile(r, state, traffic, device, frames):
    """(state, device ops, host ops, wall seconds) of ``frames`` frames
    of the window's loop under the profiler."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    dt, in_flight = float(traffic["dt"]), int(traffic["frames_in_flight"])
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, frame, _, _, _ = frame_loop(r, state, dt, in_flight, device,
                                           until=None, count=frames)
        sync(device)
        frame.cpu()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    dev_ops, host_ops = [], []
    for e in prof.events():
        item = (e.name, e.time_range.start, e.time_range.end)
        (dev_ops if e.device_type == cuda else host_ops).append(item)
    return state, dev_ops, host_ops, wall


def breakdown(trace: Trace) -> dict:
    by_name = {}
    for name, a, b in trace.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n[:120], s] for n, s in trace.gaps[:TOP]]}
