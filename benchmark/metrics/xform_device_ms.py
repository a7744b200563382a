"""xform_device_ms (layer: frame glue, ``ops.xform_cuda`` and
``csrc/xform.cu``): the device time per frame of XF, the waves'
per-instance transforms (4 launches in the primary wave, 2 in each bounce
wave on K1's route).  None where no such kernel ran (a program without
it)."""

UNIT = "ms"
MOVES = "frame_ms"
PATTERNS = ("instance_xform_kernel",)


def read(t):
    s, n = t.kernel_s(PATTERNS)
    return s * 1e3 / t.frames if n else None
