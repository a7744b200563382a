"""k1_device_ms (layer: traversal, ``ops.fused`` and ``csrc/traverse.cu``):
K1's device time per frame, every wave."""

UNIT = "ms"
MOVES = "frame_ms"
PATTERNS = ("trace_instanced_kernel",)


def read(t):
    s, n = t.kernel_s(PATTERNS)
    return s * 1e3 / t.frames if n else None
