"""setup_s: from process start to the end of the warm-up (the eager
frame and the ``step_n`` call that captures the graph, synchronized)."""


def read(prog):
    return prog.setup_s
