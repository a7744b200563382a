"""device_busy_ms (layer: device): the union of the device operations'
intervals in the traced stretch, per frame."""

UNIT = "ms"
MOVES = "frame_ms"


def read(t):
    if not t.device_ops:
        return None
    return t.busy_s * 1e3 / t.frames
