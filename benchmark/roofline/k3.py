"""K3, the diffuse filter (a row pass and a column pass a frame where the
diffuse wave runs): each pass reads the image's tone-mapped source (3
float32), normal (4), metallic (1) and depth (1) once and writes its
result (3) once.  Operations per pixel and pass: 33 taps of the weight
(normal dot 5, the power 32 by 5 squarings, depth term 4, product 2) and
the weighted sum (7), then the division (3)."""

PASSES = 2
PIXEL_BYTES = 4 * (3 + 4 + 1 + 1 + 3)
TAPS = 33
TAP_FLOPS = 5 + 5 + 4 + 2 + 7


def bytes_per_frame(trace):
    return PASSES * trace.width * trace.height * PIXEL_BYTES


def flops_per_frame(trace):
    return PASSES * trace.width * trace.height * (TAPS * TAP_FLOPS + 3)
