"""shade_device_ms (layer: frame glue, ``ops.shade_cuda`` and
``csrc/shade.cu``): the device time per frame of BS, the bounce waves'
hit shading and miss tap on K1's route (one launch a bounce wave: one a
frame at metallic 1, two with the diffuse wave).  None where no such
kernel ran (a program without it)."""

UNIT = "ms"
MOVES = "frame_ms"
PATTERNS = ("bounce_shade_kernel",)


def read(t):
    s, n = t.kernel_s(PATTERNS)
    return s * 1e3 / t.frames if n else None
