"""``torch.cuda.max_memory_allocated()`` from the warm-up solve to the
window's end (the fleets' inputs included), in GB (1e9 bytes)."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
