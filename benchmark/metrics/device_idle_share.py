"""device_idle_share (layer: device): 100 times one minus the union of the
device operations' intervals over the traced stretch's host wall."""

UNIT = "%"
MOVES = "frame_ms"


def read(t):
    if not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
