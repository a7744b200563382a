"""k1_box_tests_per_ray (layer: traversal, ``ops.fused`` and
``csrc/traverse.cu``): K1's child-box tests per live ray, every wave, as
K1 counts them into the program's counters (``engine.spans.counts``):
their total over the frames the program ran, per frame, over the frame's
live rays summed over its waves.  Work done, not time: a traversal
change shows here as fewer tests.  None where the program has no such
counters or they counted nothing."""

UNIT = "tests"
MOVES = "frame_ms"
KEY = "k1_box_tests"


def read(t):
    try:
        from raytracedggx_tpu_torch.engine import spans
    except ImportError:
        return None
    counts = spans.counts()
    tests, frames = sum(counts[KEY]), counts["frames"]
    rays = sum(t.live_rays.values())
    if not tests or not frames or not rays:
        return None
    return tests / frames / rays
