"""host_ms_per_frame (layer: frame loop, ``engine.renderer``'s ``step_n``,
its staging and the graph replay): the host clock inside the ``step_n``
calls of the measured window, over its frames.  Moves frame_ms where
the host, not the device, sets the pace."""

UNIT = "ms"
MOVES = "frame_ms"


def read(t):
    return t.host_ms_per_frame
