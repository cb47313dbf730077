"""Example: shape-constrained signal smoothing (the reference's ProxQP002
demo) through the PyTorch port (the JAX package's
examples/monotone_smoothing.py).

Smooths a noisy signal under piecewise-monotonicity constraints:

    min_x 0.5||x - y||^2 + 0.5*lam*||D2 x||^2   s.t.  M x <= 0

built from the finite-difference and monotonicity operators
(problems/operators.py = GenDiffOp/GenMonoOp of ProxQP002.jl:69-128), solved
with the prox-ALM (ProxQP) solver family.

    python examples/monotone_smoothing_torch.py                # the CUDA card
    python examples/monotone_smoothing_torch.py --device cpu   # the CPU
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import quadraticprogramsolver_tpu_torch as pt  # noqa: E402
from quadraticprogramsolver_tpu_torch.problems.operators import monotone_smoothing_qp  # noqa: E402


def main(device=None, n=200):
    """Smooth an n-sample signal on ``device`` (the card by default);
    returns the ProxQPSolution."""
    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 1.0, n)
    truth = np.sin(np.pi * t)            # rises to t=0.5, then falls
    y = truth + 0.08 * rng.standard_normal(n)

    P, q, C, d = monotone_smoothing_qp(y, ref_idx=[0, n // 2, n - 1],
                                       smooth_order=2, lam=2.0)
    prob = pt.make_proxqp(P, q, np.zeros((0, n)), np.zeros(0), C, d,
                          dtype=torch.float32, device=device)
    sol = pt.solve_proxqp(prob, pt.ProxQPSettings(
        max_iterations=2000, eps_abs=1e-6, eps_rel=1e-6))

    x = sol.x.cpu().numpy()
    print(f"converged: {bool(sol.info.converged)} in "
          f"{int(sol.info.iterations)} iterations")
    print(f"residuals: primal {float(sol.info.res_prim):.2e} "
          f"dual {float(sol.info.res_dual):.2e}")
    rise_ok = (np.diff(x[: n // 2 + 1]) >= -1e-5).all()
    fall_ok = (np.diff(x[n // 2:]) <= 1e-5).all()
    print(f"monotone rise/fall respected: {rise_ok}/{fall_ok}")
    print(f"rmse vs truth: noisy {np.sqrt(np.mean((y - truth)**2)):.4f} "
          f"-> smoothed {np.sqrt(np.mean((x - truth)**2)):.4f}")
    return sol


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(**vars(p.parse_args()))
