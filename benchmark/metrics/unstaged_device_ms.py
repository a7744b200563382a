"""unstaged_device_ms (layer: frame loop, ``engine.renderer``'s
``step_n``): device busy time per frame outside every frame's stage
marks, from its refit mark to its end mark (``stages.py``): the upload and
copy of the constants' row, the graph's copy of the history and the
clones of history and frame; what the stage metrics leave out."""

import stages

UNIT = "ms"
MOVES = "frame_ms"


def read(t):
    spans = stages.windows(t.device_ops)
    if not spans:
        return None
    return stages.outside_s(t.device_ops, spans) * 1e3 / t.frames
