"""The prox loop's device-to-host reads per solve: the program's counters
``models.proxqp._solve_impl.syncs`` (one a check pass that reads the loop's
flags) over ``_solve_impl.solves`` (one a solve), over the whole process.
Every solve of a cell does the same work on its pool (the warm-up, the
window and the traced solves alike), so the ratio over the process is the
window's. A program without the counters reads nothing."""


def read(run):
    from quadraticprogramsolver_tpu_torch.models import proxqp

    impl = proxqp._solve_impl
    syncs = getattr(impl, "syncs", None)
    solves = getattr(impl, "solves", None)
    if syncs is None or not solves:
        return None
    return syncs / solves
