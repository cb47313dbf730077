"""Example: a sharded fleet of split-form QPs on the prox-ALM family, through
the PyTorch port (the JAX package's examples/prox_fleet.py).

The second solver family (ProxQP.jl:118-173) at its measured best: a fleet
of dense `min 0.5 x'Px + q'x s.t. Ax=b, Cx<=d` problems solved batched and
split over the ranks of a device mesh (parallel/mesh.solve_prox_fleet; here
one rank, this process). On the card the example runs bench's tuned prox
stack (sigma-free column cache, 2-lane fused chunk with bf16x3 dots and a
"default" first chunk, static rho 0.0125) at B=4096, n=512, 128 equality and
128 inequality rows; on the CPU a small fleet at the default settings.

Routing note: equality-heavy split problems belong on THIS family —
scalar-rho ADMM on their box-form lowering degrades on hard equality rows;
prox-ALM handles them exactly.

    python examples/prox_fleet_torch.py                # the CUDA card
    python examples/prox_fleet_torch.py --device cpu   # the CPU (small shapes)
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import quadraticprogramsolver_tpu_torch as pt  # noqa: E402
from quadraticprogramsolver_tpu_torch.core.problem import default_device  # noqa: E402
from quadraticprogramsolver_tpu_torch.parallel.launch import one_rank_world  # noqa: E402
from quadraticprogramsolver_tpu_torch.parallel.mesh import (  # noqa: E402
    make_fleet_mesh, solve_prox_fleet)
from quadraticprogramsolver_tpu_torch.problems.prox_fleet import device_prox_fleet  # noqa: E402


def host_fleet(B, n, me, mi, device):
    """A random strictly-feasible fleet made lane by lane on the host (the
    shape of ProxQP001.jl's demo)."""
    lanes = []
    for s in range(B):
        r = np.random.default_rng(s)
        M = r.standard_normal((n, n))
        P = (M @ M.T / n + np.eye(n)).astype(np.float32)
        A = r.standard_normal((me, n)).astype(np.float32)
        C = r.standard_normal((mi, n)).astype(np.float32)
        xf = r.standard_normal(n).astype(np.float32)
        lanes.append((P, r.standard_normal(n).astype(np.float32), A, A @ xf,
                      C, C @ xf + 1.0))
    return pt.make_proxqp(*(np.stack(parts) for parts in zip(*lanes)),
                          dtype=torch.float32, device=device)


def main(device=None, B=None, n=None, me=None, mi=None):
    """Solve the fleet on ``device`` (the card by default); sizes default to
    (4096, 512, 128, 128) on the card and (32, 64, 8, 16) on the CPU.
    Returns the ProxQPSolution."""
    dev = default_device(device)
    on_card = dev.type == "cuda"
    sizes = (4096, 512, 128, 128) if on_card else (32, 64, 8, 16)
    B, n, me, mi = (s if v is None else v for v, s in zip((B, n, me, mi), sizes))

    if on_card:
        # Generated on the card (P alone is 4 GiB at the default shape).
        prob = device_prox_fleet(
            B, n, me, mi, generator=torch.Generator(device=dev).manual_seed(0))
        st = pt.ProxQPSettings(
            max_iterations=2000, eps_abs=5e-5, eps_rel=5e-5,
            rho=0.0125, adaptive_rho=False,       # recorded selection recipe
            check_interval=25,
            kkt_warm_start=False, sigma_free_rhs=True, kkt_refinement_steps=0,
            fused_chunk=True, chunk_lanes=2, chunk_dot_precision="high",
            first_chunk_dot_precision="default")
    else:
        prob = host_fleet(B, n, me, mi, dev)
        st = pt.ProxQPSettings(max_iterations=2000, eps_abs=1e-6, eps_rel=1e-6,
                               kkt_warm_start=False)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    with one_rank_world(dev.type):
        mesh = make_fleet_mesh(dev.type)
        sol = solve_prox_fleet(prob, st, mesh)     # warm call
        sync()
        dt = None
        for _ in range(3):
            t0 = time.perf_counter()
            sol = solve_prox_fleet(prob, st, mesh)
            sync()
            t = time.perf_counter() - t0
            dt = t if dt is None else min(dt, t)
        n_dev = mesh.size()

    conv = int(sol.info.converged.sum())
    iters = sol.info.iterations.cpu().numpy()
    print(f"mesh: {n_dev} device(s); fleet B={B}, n={n}, eq={me}, ineq={mi}")
    print(f"solved {conv}/{B} in {dt*1e3:.0f} ms ({conv/dt:.0f} solves/s), "
          f"iters p50={np.median(iters):.0f} max={iters.max()}")
    # Feasibility spot check on one lane.
    i = 0
    x = sol.x[i].double()
    eq = float((prob.A[i].double() @ x - prob.b[i].double()).abs().max())
    ineq = float((prob.C[i].double() @ x - prob.d[i].double()).max())
    print(f"lane 0 feasibility: |Ax-b|_inf = {eq:.2e}, max(Cx-d) = {ineq:.2e}")
    return sol


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(**vars(p.parse_args()))
