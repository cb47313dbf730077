"""Example: a sharded fleet of warm-started MPC sequences, through the
PyTorch port (the JAX package's examples/mpc_fleet.py).

Receding-horizon tracking control of B independent double-integrator plants
(scenarios), each re-solving its condensed input-constrained MPC QP at every
tick with drifting targets. Two axes of the framework compose:

  * time axis  -> `frontends/sequence.solve_sequence` (carrying (x, z, y)
    from tick to tick — the warm-start role of the reference's ``vX``
    argument, SolveQuadraticProgram.jl:14)
  * fleet axis -> `parallel/mesh.shard_fleet` over a fleet mesh
    (`make_fleet_mesh`; each rank owns a slice of the scenarios; here one
    rank, this process)

    python examples/mpc_fleet_torch.py                # the CUDA card
    python examples/mpc_fleet_torch.py --device cpu   # the CPU

MPC formulation (condensed): double integrator s' = [[1,dt],[0,1]] s +
[dt^2/2, dt] u, horizon H, decision variables = inputs u_0..u_{H-1},

    min_u 0.5 u'(G'QG + R)u + (G'Q(F s_t - r_t))'u   s.t. |u| <= u_max

where G/F map inputs/initial state to the stacked predicted positions.
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import quadraticprogramsolver_tpu_torch as pt  # noqa: E402
from quadraticprogramsolver_tpu_torch.core.problem import default_device  # noqa: E402
from quadraticprogramsolver_tpu_torch.frontends.sequence import (  # noqa: E402
    solve_sequence, solve_sequence_vectors)
from quadraticprogramsolver_tpu_torch.parallel.launch import one_rank_world  # noqa: E402
from quadraticprogramsolver_tpu_torch.parallel.mesh import (  # noqa: E402
    make_fleet_mesh, shard_fleet)


def build_condensed_mpc(H, dt_s, q_w, r_w):
    """Condensed matrices: P (H,H), and (F, G) with pos = F s0 + G u."""
    A = np.array([[1.0, dt_s], [0.0, 1.0]])
    Bv = np.array([0.5 * dt_s**2, dt_s])
    # state_k = A^k s0 + sum_j A^(k-1-j) B u_j ; we track position (row 0).
    pows = [np.linalg.matrix_power(A, k) for k in range(H + 1)]
    F = np.stack([pows[k + 1][0, :] for k in range(H)])          # (H, 2)
    G = np.zeros((H, H))
    for k in range(H):
        for j in range(k + 1):
            G[k, j] = (pows[k - j] @ Bv)[0]
    P = q_w * G.T @ G + r_w * np.eye(H)
    return P, F, G


def shard_ticks(qp_seq, mesh):
    """This rank's scenarios of a (T, B, ...) sequence: shard_fleet on the
    fleet axis (axis 1; axis 0 is time)."""
    fleet_major = pt.QP(*(t.movedim(0, 1) for t in qp_seq.tensors()))
    local = shard_fleet(fleet_major, mesh)
    return pt.QP(*(t.movedim(0, 1).contiguous() for t in local.tensors()))


def tiled_sequence(P, q_seq, u_max, device):
    """A (T, B, ...) sequence with P and A = I tiled to every tick and lane."""
    T, B, H = q_seq.shape
    kw = dict(dtype=torch.float32, device=device)
    return pt.QP(
        P=torch.as_tensor(P, **kw).expand(T, B, H, H).contiguous(),
        q=torch.as_tensor(q_seq, **kw),
        A=torch.eye(H, **kw).expand(T, B, H, H).contiguous(),
        l=torch.full((T, B, H), -u_max, **kw),
        u=torch.full((T, B, H), u_max, **kw))


def main(device=None, B=32, T=40, H=16, H2=128, B2=64, H3=None, B3=None,
         T3=None):
    """Run the example on ``device`` (the card by default). The headline
    ticks' (H3, B3, T3) default to (512, 2048, 8) on the card and (64, 32,
    4) on the CPU. Returns {"sequence", "reuse", "cached"}: the Solutions of
    the sharded sequence, its factor-reuse twin and the last cached tick."""
    dev = default_device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    dt_s, u_max = 0.1, 3.0
    P, F, G = build_condensed_mpc(H, dt_s, q_w=1.0, r_w=0.05)
    rng = np.random.default_rng(0)
    targets = rng.uniform(-0.6, 0.6, B)              # per-scenario setpoint

    # Simulate the closed loop on the host to produce the drifting q_t
    # sequence (in a real deployment each tick's q comes from the measured
    # state; here we roll the plant forward with a crude proportional input;
    # the QP solution below is what a controller would actually apply).
    A2 = np.array([[1.0, dt_s], [0.0, 1.0]])
    Bv = np.array([0.5 * dt_s**2, dt_s])
    s = np.zeros((B, 2))
    qs = []
    for _ in range(T):
        r = np.tile(targets[:, None], (1, H))        # constant reference
        qs.append((G.T @ (1.0 * (F @ s.T - r.T))).T)  # (B, H)
        u_prev = np.clip(1.0 * (targets - s[:, 0]) - 0.6 * s[:, 1], -u_max, u_max)
        s = s @ A2.T + np.outer(u_prev, Bv)

    # check_interval=5: fine exit granularity makes the warm-start payoff
    # visible in the per-tick iteration counts (these QPs converge within
    # a handful of iterations once warm).
    st = pt.Settings(max_iterations=1000, eps_abs=1e-5, eps_rel=1e-5,
                     rho=0.1, adaptive_rho=True, check_interval=5)

    with one_rank_world(dev.type):
        mesh = make_fleet_mesh(dev.type)
        n_dev = mesh.size()
        qp_seq = shard_ticks(tiled_sequence(P, np.stack(qs), u_max, dev), mesh)

    # carry_rho=False: on this workload carrying the adapted rho between
    # ticks costs more iterations than carrying the iterates alone
    # (frontends/sequence.py).
    def timed(fn):
        fn()                                         # warm call
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    sols, wall = timed(lambda: solve_sequence(qp_seq, st, carry_rho=False))
    status = sols.info.status.cpu().numpy()          # (T, B)
    iters = sols.info.iterations.cpu().numpy()
    if not (status >= 2).all():
        raise RuntimeError("unsolved tick")
    u0 = sols.x[:, :, 0].cpu().numpy()               # applied input per tick
    print(f"mesh: {n_dev} devices; fleet B={B}, ticks T={T}, n={H}")
    print(f"solved {T * B} QPs in {wall*1e3:.0f} ms "
          f"({T * B / wall:.0f} solves/s)")
    print(f"iterations: tick0 p50={np.median(iters[0]):.0f}, "
          f"warm-started p50 over ticks 1+ = {np.median(iters[1:]):.0f}")
    print(f"|u0| respects bound: max {np.abs(u0).max():.3f} <= {u_max}")

    # ---- Factor reuse (static_matrices): P and A are tick-invariant in
    # MPC, so the KKT factor can be built ONCE before the ticks
    # (models/admm.prepare) instead of once per tick. The effect scales
    # with the factor's share of a tick — tiny at H=16, dominant at larger
    # horizons, so measure both.
    sols_fr, wall_fr = timed(lambda: solve_sequence(
        qp_seq, st, carry_rho=False, static_matrices=True))
    if not (sols_fr.info.status >= 2).all():
        raise RuntimeError("unsolved tick (factor reuse)")
    dev_x = float((sols_fr.x - sols.x).abs().max())
    print(f"factor reuse (H={H}): {wall*1e3:.0f} -> {wall_fr*1e3:.0f} ms "
          f"({wall / wall_fr:.2f}x; max |dx| vs per-tick factor {dev_x:.1e})")

    # Larger-horizon shape for the factor-share measurement. The condensed
    # double integrator at H=128 is too ill-conditioned for f32 (G entries
    # grow ~k^2), so use a well-conditioned synthetic SPD tracking cost of
    # the same shape — the factor/iterate split is what's being measured,
    # not the plant.
    rng2 = np.random.default_rng(1)
    M2 = rng2.standard_normal((H2, H2))
    P2 = (M2 @ M2.T / H2 + np.eye(H2)).astype(np.float32)
    q_seq2 = rng2.standard_normal((T, B2, H2)).astype(np.float32) * 0.1
    qp_seq2 = tiled_sequence(P2, q_seq2, u_max, dev)
    walls = {}
    for label, static in (("per-tick factor", False), ("factor reuse", True)):
        s2, walls[label] = timed(lambda: solve_sequence(
            qp_seq2, st, carry_rho=False, static_matrices=static))
        if not (s2.info.status >= 2).all():
            raise RuntimeError(f"unsolved tick ({label}, H={H2})")
    speedup = walls["per-tick factor"] / walls["factor reuse"]
    print(f"factor reuse (H={H2}, B={B2}): "
          f"{walls['per-tick factor']*1e3:.0f} -> "
          f"{walls['factor reuse']*1e3:.0f} ms ({speedup:.2f}x tick throughput)")
    del qp_seq2, s2

    # Headline-scale ticks via solve_sequence_vectors (P/A stored ONCE, not
    # tiled T times).
    H3, B3, T3 = (v if v is not None else d for v, d in zip(
        (H3, B3, T3), (512, 2048, 8) if on_card else (64, 32, 4)))
    rng3 = np.random.default_rng(2)
    M3 = rng3.standard_normal((H3, H3)).astype(np.float32)
    P3 = (M3 @ M3.T / H3 + 0.01 * np.eye(H3, dtype=np.float32))
    kw = dict(dtype=torch.float32, device=dev)
    # P/A stored UNBATCHED (shared across the fleet): the batch shape comes
    # from q, and every consumer broadcasts.
    qp3 = pt.QP(
        P=torch.as_tensor(P3, **kw),
        q=torch.as_tensor(rng3.standard_normal((B3, H3)).astype(np.float32), **kw),
        A=torch.eye(H3, **kw),
        l=torch.full((B3, H3), -u_max, **kw),
        u=torch.full((B3, H3), u_max, **kw))
    # Receding-horizon drift: each tick's cost is a small perturbation of
    # the last (the MPC regime warm starts exist for) — NOT fresh random
    # costs, which would make every tick a cold solve of a new problem.
    q0 = rng3.standard_normal((B3, H3)).astype(np.float32)
    dq = rng3.standard_normal((T3, B3, H3)).astype(np.float32) * 0.02
    q_host = q0[None] + np.cumsum(dq, axis=0)
    q_seq3 = torch.as_tensor(q_host, **kw)
    # rho=0.4: the family-tuned penalty; static rho so the prepared factor
    # stays valid all horizon.
    st3 = pt.Settings(max_iterations=1000, eps_abs=1e-4, eps_rel=1e-4,
                      rho=0.4, adaptive_rho=False, check_interval=12)
    # (a) One sequence call with and without the carried prepared factor.
    walls3 = {}
    for label, reuse in (("per-tick factor", False), ("factor reuse", True)):
        s3, walls3[label] = timed(lambda: solve_sequence_vectors(
            qp3, q_seq3, settings=st3, reuse_factor=reuse))
        if not (s3.info.status >= 2).all():
            raise RuntimeError(f"unsolved tick ({label}, n={H3})")
    speedup3 = walls3["per-tick factor"] / walls3["factor reuse"]
    print(f"factor reuse, one sequence call (n={H3}, B={B3}, T={T3} ticks): "
          f"{walls3['per-tick factor']*1e3:.0f} -> "
          f"{walls3['factor reuse']*1e3:.0f} ms "
          f"({speedup3:.2f}x tick throughput)")

    # (b) Host-driven ticks (one call per tick — the deployment shape when
    # tick data arrives from outside): every fresh solve call re-pays the
    # factor; CachedQPSolver pays it once at setup.
    def naive_ticks():
        warm = {}
        for t in range(T3):
            qp_t = dataclasses.replace(qp3, q=torch.as_tensor(q_host[t], **kw))
            sol_t = pt.solve(qp_t, st3, **warm)
            warm = dict(x0=sol_t.x, z0=sol_t.z, y0=sol_t.y)
        return sol_t

    sol_t, naive = timed(naive_ticks)
    solver = pt.CachedQPSolver(qp3, st3)

    def cached_ticks():
        for t in range(T3):
            solver.update(q=q_host[t])
            sol_c = solver.solve(warm_start=(t > 0))
        return sol_c

    sol_c, cached = timed(cached_ticks)
    if not (sol_c.info.status >= 2).all():
        raise RuntimeError("unsolved cached tick")
    dev3 = float((sol_c.x - sol_t.x).abs().max())
    print(f"factor reuse, host-driven ticks (n={H3}, B={B3}, {T3} ticks): "
          f"{naive*1e3:.0f} -> {cached*1e3:.0f} ms "
          f"({naive / cached:.2f}x tick throughput; final-tick |dx| "
          f"{dev3:.1e})")
    return {"sequence": sols, "reuse": sols_fr, "cached": sol_c}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(**vars(p.parse_args()))
