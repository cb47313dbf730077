"""The 95th percentile of one fleet solve's time over every solve of the
window: CUDA events recorded just before the solve is called and just after
it returns, so the time runs from the call to its last kernel's end,
host-side waits included, at the device clock's resolution."""

import statistics


def read(run):
    if len(run.solve_ms) < 20:
        return None
    return statistics.quantiles(run.solve_ms, n=20, method="inclusive")[18]
