"""tonemap_stage_ms (layer: frame stages): the tone map
(``post/tonemap.py``): device time per frame from the stage's mark to the
next mark, start to start (``stages.py``)."""

import stages

UNIT = "ms"
MOVES = "frame_ms"
STAGE = "tonemap"


def read(t):
    return stages.stage_ms(t, STAGE)
