"""reflection_stage_ms (layer: frame stages): the reflection wave
(``ray_trace_pass``: GGX sample, the bounce sort, K1,
``_shade_secondary``, the BRDF weight): device time per frame from the
stage's mark to the next mark, start to start (``stages.py``)."""

import stages

UNIT = "ms"
MOVES = "frame_ms"
STAGE = "reflection"


def read(t):
    return stages.stage_ms(t, STAGE)
