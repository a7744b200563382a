"""frame_mfu (layer: frame, the whole of ``Renderer.step_n``'s frame):
the frame's least time, the larger of its bytes over the peak bandwidth
and its float32 operations over the peak rate (``roofline/frame.py``,
``peaks.json``), as a share of the traced stretch's wall per frame.  It
bounds what any kernel's roofline share can claim end to end."""

UNIT = "%"
MOVES = "frame_ms"
KERNEL = "frame"


def read(t):
    if not t.device_ops:
        return None
    count = t.roofline(KERNEL)
    least = max(count.bytes_per_frame(t) / t.peaks["hbm_bytes_per_s"],
                count.flops_per_frame(t) / t.peaks["fp32_flops_per_s"])
    return 100.0 * least / (t.wall_s / t.frames)
