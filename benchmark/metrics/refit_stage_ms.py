"""refit_stage_ms (layer: frame stages): the TLAS build and the scene BVH's
refit (``Renderer._refit``: ``bvh/tlas.py``,
``ops/scene_wide.refit_scene_wide``): device time per frame from the
stage's mark to the next mark, start to start (``stages.py``)."""

import stages

UNIT = "ms"
MOVES = "frame_ms"
STAGE = "refit"


def read(t):
    return stages.stage_ms(t, STAGE)
