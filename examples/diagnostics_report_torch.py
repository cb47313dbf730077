"""Diagnostic-report example: residual trace + constraint map + scatter,
through the PyTorch port (the JAX package's examples/diagnostics_report.py).

    python examples/diagnostics_report_torch.py [--out PREFIX] [--n N] [--device cpu]

Covers the reference's manual-verification plot role
(SolveQuadraticProgramUnitTest.jl:78-79, ProxQP002.jl:190-212): solve one
portfolio QP with per-check tracing on, print the text report, and render
the PNG when matplotlib is available. The report goes to PREFIX.txt (and
PREFIX.png), by default qp_report in the temporary directory.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import quadraticprogramsolver_tpu_torch as pt  # noqa: E402
from quadraticprogramsolver_tpu_torch.utils.diagnostics import (  # noqa: E402
    save_report_png, solve_report)


def main(device=None, n=120, out=None):
    """Solve one portfolio QP in f64 on ``device`` (the card by default)
    and write its report; returns the Solution."""
    out = os.path.join(tempfile.gettempdir(), "qp_report") if out is None else out
    data = pt.generate_random_qp(pt.ProblemClass.PORTFOLIO, n, seed=1)
    qp_arrays = data.dense()
    settings = pt.Settings(eps_abs=1e-6, eps_rel=1e-6, rho=0.1,
                           adaptive_rho=True, record_history=True,
                           check_interval=25)
    sol = pt.solve(pt.make_qp(*qp_arrays, dtype=torch.float64, device=device),
                   settings)

    report = solve_report(qp_arrays, sol,
                          check_interval=settings.check_interval)
    print(report)
    txt = out + ".txt"
    with open(txt, "w") as f:
        f.write(report)
    print(f"text report -> {txt}")
    png = save_report_png(qp_arrays, sol, out + ".png",
                          check_interval=settings.check_interval)
    print(f"png report  -> {png}" if png else "matplotlib unavailable; "
          "text report only")
    return sol


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None)
    p.add_argument("--n", type=int, default=120)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(**vars(p.parse_args()))
