"""Frame statistics: windowed FPS like CalculateFrameStats
(RayTracedGGX.cpp:741-777), fps averaged over >= 1 s windows, exposed as a
stats line (the reference writes it to the window title together with the
toggle states and current mesh/metallic).

Copied from raytracedggx_tpu/engine/stats.py (host code, no arrays).
"""

from __future__ import annotations

import time


class FrameStats:
    def __init__(self):
        self.frame_cnt = 0
        self.prev_time = time.monotonic()
        self.start = self.prev_time
        self.fps = 0.0
        self.last_dt = 0.0
        self._last = self.prev_time

    def tick(self) -> float:
        """Returns the time step since the previous tick (seconds)."""
        now = time.monotonic()
        self.last_dt = now - self._last
        self._last = now
        self.frame_cnt += 1
        if now - self.prev_time >= 1.0:
            self.fps = self.frame_cnt / (now - self.prev_time)
            self.frame_cnt = 0
            self.prev_time = now
        return self.last_dt

    def title(self, name: str = "RayTracedGGX-CUDA", **toggles) -> str:
        flags = " ".join(f"[{k}]{v}" for k, v in toggles.items())
        return f"{name}: {self.fps:.1f} fps {flags}".strip()
