"""device_ops_per_frame (layer: frame glue): device operations (kernels,
copies, sets) in the traced stretch, per frame; what fusion lowers."""

UNIT = "ops"
MOVES = "frame_ms"


def read(t):
    if not t.device_ops:
        return None
    return len(t.device_ops) / t.frames
