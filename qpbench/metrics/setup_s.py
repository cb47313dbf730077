"""Set-up: from the process's start (before torch is imported) to the first
timed solve: imports, the kernels' load (their nvcc build in the first run
of a checkout), the fleets made on the card and the warm-up solve."""


def read(run):
    return run.setup_s
