"""Diagnostic reports: residual traces and constraint-violation maps
(counterpart of the JAX package's utils/diagnostics.py, whose package
imports jax).

A text report of one lane of a Solution or ProxQPSolution always, and a PNG
(residual trace, constraint map, solution scatter) when matplotlib is
importable. Everything runs on the host from arrays moved there (tensors on
any device, or numpy arrays); nothing here enters the compute path. For the
same numbers the text is the JAX package's, character for character.
"""

from __future__ import annotations

import io

import numpy as np

from .interop import to_host

_STATUS_NAMES = {
    0: "RUNNING", 1: "MAX_ITERATIONS", 2: "SOLVED_ADMM", 3: "SOLVED",
    4: "PRIMAL_INFEASIBLE", 5: "DUAL_INFEASIBLE",
}


def _lane(arr, lane):
    a = to_host(arr)
    return a if a.ndim == 0 or lane is None else a[lane]


def _trace(hist, key, lane):
    """One lane of a (num_checks, *B) history entry, checks last."""
    return np.asarray(_lane(np.moveaxis(to_host(hist[key]), 0, -1), lane))


def constraint_map(qp_arrays, x):
    """Per-constraint slack and violation numbers for one problem instance:
    min(Ax - l), min(u - Ax) (negative = violated), the counts of rows
    active at each bound and of violated rows, and the worst rows."""
    _, _, A, l, u = (np.asarray(to_host(v), np.float64) for v in qp_arrays)
    x = np.asarray(to_host(x), np.float64)
    Ax = A @ x
    low_gap = Ax - l         # negative => lower bound violated
    up_gap = u - Ax          # negative => upper bound violated
    tol = 1e-8 * np.maximum(1.0, np.abs(Ax))
    return {
        "Ax": Ax,
        "low_gap": low_gap,
        "up_gap": up_gap,
        "min_low_gap": float(np.min(low_gap)) if low_gap.size else 0.0,
        "min_up_gap": float(np.min(up_gap)) if up_gap.size else 0.0,
        "n_active_low": int(np.sum(np.isfinite(l) & (low_gap <= tol))),
        "n_active_up": int(np.sum(np.isfinite(u) & (up_gap <= tol))),
        "n_violated": int(np.sum((low_gap < -tol) | (up_gap < -tol))),
        "worst_rows": np.argsort(np.minimum(low_gap, up_gap))[:5].tolist(),
    }


def solve_report(qp_arrays, sol, lane=None, check_interval: int = 1,
                 max_trace_rows: int = 40) -> str:
    """Text diagnostic report for one lane of a Solution.

    Args:
      qp_arrays: (P, q, A, l, u) of the (single) problem: for a fleet pass
        the lane's slices.
      sol: a Solution (box form) or ProxQPSolution; for fleets give ``lane``.
      check_interval: the Settings.check_interval used (annotates the trace
        with iteration numbers).
    """
    info = sol.info
    status = int(_lane(info.status, lane))
    iters = int(_lane(info.iterations, lane))
    x = np.asarray(_lane(sol.x, lane))
    out = io.StringIO()
    w = out.write
    w("=== QP solve diagnostic report ===\n")
    w(f"status     : {status} ({_STATUS_NAMES.get(status, '?')})\n")
    w(f"iterations : {iters}\n")
    w(f"res_prim   : {float(_lane(info.res_prim, lane)):.3e}\n")
    w(f"res_dual   : {float(_lane(info.res_dual, lane)):.3e}\n")
    w(f"rho (final): {float(_lane(info.rho, lane)):.3e}\n")
    obj = getattr(info, "objective", None)
    if obj is not None:
        w(f"objective  : {float(_lane(obj, lane)):.6e}\n")
    w(f"x          : n={x.size}, |x|_inf={np.abs(x).max():.3e}, "
      f"mean={x.mean():.3e}\n")

    cm = constraint_map(qp_arrays, x)
    w("\n--- constraint map (reference: SolveQuadraticProgramUnitTest.m:102) ---\n")
    w(f"min(Ax - l)      : {cm['min_low_gap']:+.3e}"
      f"  (negative = lower bound violated)\n")
    w(f"min(u - Ax)      : {cm['min_up_gap']:+.3e}"
      f"  (negative = upper bound violated)\n")
    w(f"active at lower  : {cm['n_active_low']}\n")
    w(f"active at upper  : {cm['n_active_up']}\n")
    w(f"violated rows    : {cm['n_violated']}\n")
    if cm["n_violated"]:
        w(f"worst rows       : {cm['worst_rows']}\n")

    hist = info.history
    if hist is not None:
        rp, rd, rho = (_trace(hist, k, lane) for k in ("res_prim", "res_dual", "rho"))
        idx = np.where(np.isfinite(rp))[0]
        w("\n--- residual trace (per check) ---\n")
        w(f"{'iter':>6s} {'res_prim':>12s} {'res_dual':>12s} {'rho':>10s}\n")
        step = max(1, len(idx) // max_trace_rows)
        shown = list(idx[::step])
        if len(idx) and idx[-1] not in shown:
            shown.append(idx[-1])
        for i in shown:
            w(f"{(i + 1) * check_interval:6d} {rp[i]:12.3e} {rd[i]:12.3e} "
              f"{rho[i]:10.3e}\n")
    return out.getvalue()


def save_report_png(qp_arrays, sol, path, lane=None, check_interval: int = 1):
    """Render the report as a PNG (residual trace, constraint map, solution
    scatter). Returns the path, or None when matplotlib is not importable
    (the text report is then the only one)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    info = sol.info
    x = np.asarray(_lane(sol.x, lane))
    cm = constraint_map(qp_arrays, x)
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6))

    ax = axes[0]
    hist = info.history
    if hist is not None:
        rp, rd = (_trace(hist, k, lane) for k in ("res_prim", "res_dual"))
        it = (np.arange(len(rp)) + 1) * check_interval
        v = np.isfinite(rp)
        ax.semilogy(it[v], rp[v], label="res_prim")
        ax.semilogy(it[v], rd[v], label="res_dual")
        ax.legend()
    else:
        ax.text(0.5, 0.5, "no history recorded\n(record_history=False)",
                ha="center", va="center", transform=ax.transAxes)
    ax.set_title("residual trace")
    ax.set_xlabel("iteration")

    ax = axes[1]
    ax.plot(cm["low_gap"], ".", ms=3, label="Ax - l")
    ax.plot(cm["up_gap"], ".", ms=3, label="u - Ax")
    ax.axhline(0.0, color="k", lw=0.6)
    ax.set_title(f"constraint map ({cm['Ax'].size} rows)")
    ax.set_xlabel("constraint row")
    ax.legend()

    ax = axes[2]
    ax.plot(x, ".", ms=3)
    ax.set_title("solution scatter")
    ax.set_xlabel("variable index")

    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
