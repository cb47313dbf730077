"""The slowest lane's iterations (``Solution.info.iterations``), averaged
over the window's solves: a fleet solve runs until its slowest lane is
done."""


def read(run):
    v = run.lane_iters_max
    return sum(v) / len(v) if v else None
