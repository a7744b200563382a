"""primary_stage_ms (layer: frame stages): the primary wave
(``trace/raygen.py:primary_surface``: camera rays, K1, the G-buffers,
depth and velocity): device time per frame from the stage's mark to the
next mark, start to start (``stages.py``)."""

import stages

UNIT = "ms"
MOVES = "frame_ms"
STAGE = "primary"


def read(t):
    return stages.stage_ms(t, STAGE)
