"""K1, the closest-hit traversal (one launch per wave): the least bytes
and operations of a frame's waves, counted from their inputs and outputs
and never from a tree or a walk.  Each live ray of a wave is read once
(origin, direction, t_min, t_max), its hit record written once (t, u,
v, slot, instance), and every triangle of the scene read once a wave
(three float32 vertices).  Operations: one ray-triangle test per live
ray, the hit's own."""

RAY_BYTES = 4 * (3 + 3 + 1 + 1)
HIT_BYTES = 4 * 5
TRIANGLE_BYTES = 4 * 9
TEST_FLOPS = 27 * 2          # Moller-Trumbore: 27 multiply-adds


def bytes_per_frame(trace):
    rays = sum(trace.live_rays.values())
    waves = len(trace.live_rays)
    return (rays * (RAY_BYTES + HIT_BYTES)
            + waves * sum(trace.triangles.values()) * TRIANGLE_BYTES)


def flops_per_frame(trace):
    return sum(trace.live_rays.values()) * TEST_FLOPS
