"""k1_roofline (layer: traversal): K1's least time, the larger of its bytes
over the peak bandwidth and its float32 operations over the peak rate
(``roofline/k1.py``, ``peaks.json``), as a share of its device time
per frame."""

UNIT = "%"
MOVES = "frame_ms"
PATTERNS = ("trace_instanced_kernel",)
KERNEL = "k1"


def read(t):
    s, n = t.kernel_s(PATTERNS)
    if not n:
        return None
    count = t.roofline(KERNEL)
    least = max(count.bytes_per_frame(t) / t.peaks["hbm_bytes_per_s"],
                count.flops_per_frame(t) / t.peaks["fp32_flops_per_s"])
    return 100.0 * least / (s / t.frames)
