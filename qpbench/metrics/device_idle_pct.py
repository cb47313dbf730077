"""1 - busy / wall over the traced solves, in %: busy is the union of the
device events' intervals in the trace, wall the traced solves' host-clock
time."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
