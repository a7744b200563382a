"""diffuse_stage_ms (layer: frame stages): the diffuse wave behind its gate
(``ray_trace_pass``: cosine sample, the bounce sort, K1, shading); only
where an instance has metallic below 1: device time per frame from the
stage's mark to the next mark, start to start (``stages.py``)."""

import stages

UNIT = "ms"
MOVES = "frame_ms"
STAGE = "diffuse"


def read(t):
    return stages.stage_ms(t, STAGE)
