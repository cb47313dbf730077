"""The increase of the program's counter
``models.admm._solve_core.syncs`` (one device-to-host read a check) per
solve of the window. The prox loop keeps no such counter: nothing to
read there."""


def read(run):
    if run.syncs is None or not run.lane_iters_max:
        return None
    return run.syncs / len(run.lane_iters_max)
