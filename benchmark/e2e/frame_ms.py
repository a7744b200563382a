"""frame_ms: the measured window's host wall, from the first frame's issue
to the host read of the last, over the frames issued in it."""


def read(prog):
    return prog.wall_s * 1e3 / prog.frames
