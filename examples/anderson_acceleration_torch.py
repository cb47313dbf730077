"""Example: safeguarded Anderson acceleration on a slow-converging fleet,
through the PyTorch port (the JAX package's
examples/anderson_acceleration.py).

The inequality-heavy OSQP-paper family (m = 10n dense rows) is the measured
worst case for plain ADMM at tight tolerances: stragglers need 1000+
iterations. `Settings.anderson_memory` turns on guarded type-II Anderson
acceleration of the fixed point (models/anderson.py) — per-lane, safeguarded
so it can never lose to the plain iteration — and roughly halves the
straggler iteration counts.

    python examples/anderson_acceleration_torch.py                # f32 on the CUDA card
    python examples/anderson_acceleration_torch.py --device cpu   # f64 on the CPU
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import quadraticprogramsolver_tpu_torch as pt  # noqa: E402


def main(device=None, batch=32, n=100):
    """Solve the fleet plain and with anderson_memory=8 on ``device`` (the
    card by default, in f32; the CPU in f64); returns {memory: Solution}."""
    on_cpu = device is not None and str(device).startswith("cpu")
    dtype = np.float64 if on_cpu else np.float32
    fleet = pt.generate_batch(pt.ProblemClass.INEQUALITY_QP, batch, n,
                              seed=0, dtype=dtype, device=device)
    base = pt.Settings(eps_abs=1e-6, eps_rel=1e-6, rho=0.1,
                       max_iterations=4000, check_interval=25)

    sols = {}
    for mem in (0, 8):
        st = dataclasses.replace(base, anderson_memory=mem)
        t0 = time.time()
        sol = pt.solve(fleet, st)
        iters = sol.info.iterations.cpu().numpy()
        status = sol.info.status.cpu().numpy()
        solved = int(((status == 2) | (status == 3)).sum())
        label = f"anderson_memory={mem}" if mem else "plain ADMM        "
        print(f"{label}: solved {solved}/{batch}, iterations "
              f"p50={int(np.median(iters))} max={int(iters.max())} "
              f"total={int(iters.sum())}  ({time.time()-t0:.1f}s)")
        sols[mem] = sol
    return sols


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(**vars(p.parse_args()))
