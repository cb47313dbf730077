"""The iterate chunks' least time over their device time, in %.

The count reads the work, not the route: per lane and per chunk of
``check_interval`` iterations in which the lane is active (ceil(its
iterations / check_interval) chunks, from the traced solves' own
``info.iterations``), read the triangular factor (n(n+1)/2 floats) and A
(for the split form [A; C]) once, and do the iterations' products: two
triangular solves (2 n^2) and the products with A and A' (4 m n) an
iteration. Shapes are the problem's own, float32. The least time is the
larger of the bytes over the HBM peak and the operations over the dense
tensor-core peak."""

import math

#: NVIDIA H100 SXM: HBM3 bandwidth, dense bf16/fp16 tensor-core rate.
BYTES_PER_S = 3.35e12
FLOPS_PER_S = 989e12
LAYER = "chunk.device_ms"


def lane_chunk_work(n: int, m: int, k: int) -> tuple[float, float]:
    """(operations, bytes) of one lane's chunk of k iterations."""
    return k * (2 * n * n + 4 * m * n), 4 * (n * (n + 1) // 2 + m * n)


def read(run):
    t = run.trace
    ms = t.ms_matching(run.kernels_of(LAYER)) if t is not None else 0.0
    if ms <= 0 or not run.traced_iterations:
        return None
    s = run.shape
    k = run.cell.traffic["settings"]["check_interval"]
    chunks = sum(math.ceil(int(i) / k) for it in run.traced_iterations
                 for i in it.tolist())
    flops, nbytes = lane_chunk_work(
        s["n"], s.get("m", s.get("me", 0) + s.get("mi", 0)), k)
    t_bytes, t_flops = nbytes / BYTES_PER_S, flops / FLOPS_PER_S
    least_s = chunks * max(t_bytes, t_flops)
    run.note(f"chunk.roofline_pct: {'bytes' if t_bytes >= t_flops else 'operations'}"
             f" bound, {chunks / len(run.traced_iterations):.1f} lane-chunks a "
             f"solve, least {least_s * 1e3 / t.solves:.4f} ms a solve")
    return 100.0 * least_s / (ms / 1e3)
