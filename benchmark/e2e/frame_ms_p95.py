"""frame_ms_p95: the 95th percentile of every frame-to-frame interval in
the window, between consecutive per-frame CUDA events (the first from an
event recorded as the window opened)."""

import statistics


def read(prog):
    v = prog.intervals_ms
    return statistics.quantiles(v, n=20)[-1] if len(v) > 1 else v[0]
