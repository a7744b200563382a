"""taa_stage_ms (layer: frame stages): the temporal accumulation
(``denoise/temporal.py:temporal_ss``) and the f16 store of the history:
device time per frame from the stage's mark to the next mark, start to
start (``stages.py``)."""

import stages

UNIT = "ms"
MOVES = "frame_ms"
STAGE = "taa"


def read(t):
    return stages.stage_ms(t, STAGE)
