"""Device idle ms per traced solve that the trace puts down to the port's
own host code: the idle gaps (``tracing.reduce``) named after one of the
program's ``qps.*`` spans (utils/profiling.py: ``span``; a gap is named
after the innermost host event that spans its middle, found within the
last ``tracing.SCAN`` host events), summed, over the traced solves.

A lower bound, and not yet a yardstick: the trace keeps the ten largest
names only, and which names make the ten, and whether a gap lands on a
span or on a torch call inside it, moves between runs of one tree. A
program with spans whose names miss the ten reads 0; a program without
spans reads nothing."""

#: The prefix of the program's span names.
PREFIX = "qps."


def read(run):
    from quadraticprogramsolver_tpu_torch.utils import profiling

    t = run.trace
    if t is None or not t.solves or not hasattr(profiling, "span"):
        return None
    ours = [(k, s) for k, s in t.idle_gaps if k.startswith(PREFIX)]
    for k, s in ours:
        run.note(f"idle under {k}: {1e3 * s / t.solves:.4f} ms a solve")
    return 1e3 * sum(s for _, s in ours) / t.solves
