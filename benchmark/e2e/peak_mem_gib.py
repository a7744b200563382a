"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` over set-up and the
window, in GiB."""


def read(prog):
    return prog.peak_bytes / 2**30
