"""taa_device_ms (layer: frame glue, ``ops.temporal_cuda`` and
``csrc/temporal.cu``): the device time per frame of TS, the TAA (one
launch a frame).  None where no such kernel ran (a program without it)."""

UNIT = "ms"
MOVES = "frame_ms"
PATTERNS = ("temporal_ss_kernel",)


def read(t):
    s, n = t.kernel_s(PATTERNS)
    return s * 1e3 / t.frames if n else None
