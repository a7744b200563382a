"""spatial_stage_ms (layer: frame stages): the spatial filters
(``Renderer._post_process``: K2 twice, K3 twice where the diffuse gate is
open): device time per frame from the stage's mark to the next mark, start
to start (``stages.py``)."""

import stages

UNIT = "ms"
MOVES = "frame_ms"
STAGE = "spatial"


def read(t):
    return stages.stage_ms(t, STAGE)
