"""Example: solve a fleet of portfolio-optimization QPs on one card, through
the PyTorch port (the JAX package's examples/portfolio_fleet.py).

The reference solves one portfolio instance at a time
(GenerateQuadraticProgram.jl:37-47 builds it; RunTests.jl solves it); the
fleet workflow batches hundreds of scenarios into one solve.

    python examples/portfolio_fleet_torch.py                # the CUDA card
    python examples/portfolio_fleet_torch.py --device cpu   # the CPU
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import quadraticprogramsolver_tpu_torch as pt  # noqa: E402


def main(device=None, fleet_size=128, assets=100):
    """Solve the fleet on ``device`` (the card by default); returns the
    Solution."""
    fleet = pt.generate_batch(
        pt.ProblemClass.PORTFOLIO, batch=fleet_size, num_elements=assets,
        seed=7, dtype=np.float32, device=device)
    print(f"fleet: {fleet_size} portfolio QPs, {fleet.n} vars x {fleet.m} constraints")

    settings = pt.Settings(
        eps_abs=1e-5, eps_rel=1e-5, rho=0.1, adaptive_rho=True,
        max_iterations=4000)
    sol = pt.solve(fleet, settings)

    status = sol.info.status.cpu().numpy()
    iters = sol.info.iterations.cpu().numpy()
    print(f"solved {int((status >= 2).sum())}/{fleet_size} "
          f"(iterations p50 {np.median(iters):.0f}, max {iters.max()})")

    # First `assets` variables are the asset weights; they obey the simplex
    # constraints the portfolio class encodes (sum = 1, 0 <= w <= 1).
    w = sol.x[:, :assets].cpu().numpy()
    objective = sol.info.objective.cpu().numpy()
    print(f"weight sums: min {w.sum(axis=1).min():.6f} max {w.sum(axis=1).max():.6f}")
    print(f"objective range: [{objective.min():.4f}, {objective.max():.4f}]")
    return sol


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(**vars(p.parse_args()))
