"""filter_device_ms (layer: filters, ``ops.spatial_cuda`` and
``csrc/spatial.cu``): K2's and K3's device time per frame."""

UNIT = "ms"
MOVES = "frame_ms"
PATTERNS = ("reflection_pass_kernel", "diffuse_pass_kernel")


def read(t):
    s, n = t.kernel_s(PATTERNS)
    return s * 1e3 / t.frames if n else None
