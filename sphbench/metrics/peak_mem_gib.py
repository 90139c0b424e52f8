"""peak_mem_gib: the peak of device memory allocated over the window, the
resident snapshot included (``torch.cuda.max_memory_allocated`` after a
reset at the window's start), in GiB; none off the card."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
