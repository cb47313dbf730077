"""Converged QPs per second: lanes that ended with a converged status (the
configuration's ``converged_status``), summed over every solve of the
window, over the window's whole wall time on the host clock."""


def read(run):
    return run.converged / run.window_s if run.window_s > 0 else None
