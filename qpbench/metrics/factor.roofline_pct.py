"""The factor layer's least time over its device time, in %.

The count reads the work, not the route: per lane and solve, read P, A and
q once and write one triangular n x n factor (n(n+1)/2 floats), and do the
gram A'A, one SPD factorisation (n^3/3) and its solves against [A' | q].
Shapes are the problem's own (before any padding), float32. The least time
is the larger of the bytes over the HBM peak and the operations over the
dense tensor-core peak, the fastest arithmetic that composes FP32-accurate
products (bf16x3). One factor a lane a solve (static rho)."""

#: NVIDIA H100 SXM: HBM3 bandwidth, dense bf16/fp16 tensor-core rate.
BYTES_PER_S = 3.35e12
FLOPS_PER_S = 989e12
LAYER = "factor.device_ms"


def lane_work(n: int, m: int) -> tuple[float, float]:
    """(operations, bytes) of one lane's factor."""
    flops = n * (n + 1) * m + n ** 3 / 3 + 2 * n * n * (m + 1)
    nbytes = 4 * (n * n + m * n + n) + 4 * n * (n + 1) // 2
    return flops, nbytes


def read(run):
    t = run.trace
    ms = t.ms_matching(run.kernels_of(LAYER)) if t is not None else 0.0
    if ms <= 0:
        return None
    s = run.shape
    flops, nbytes = lane_work(s["n"], s.get("m", s.get("me", 0) + s.get("mi", 0)))
    t_bytes, t_flops = nbytes / BYTES_PER_S, flops / FLOPS_PER_S
    least_s = run.batch * t.solves * max(t_bytes, t_flops)
    run.note(f"factor.roofline_pct: {'bytes' if t_bytes >= t_flops else 'operations'}"
             f" bound, least {least_s * 1e3 / t.solves:.4f} ms a solve")
    return 100.0 * least_s / (ms / 1e3)
