"""A multi-rank dry run of every distributed mode, the counterpart of the
JAX package's ``__graft_entry__.dryrun_multichip``, step for step.

    python -c "from quadraticprogramsolver_tpu_torch.parallel.dryrun import \
dryrun_multichip; dryrun_multichip(2, device='cpu')"

:func:`dryrun_multichip` spawns ``n_ranks`` ranks (parallel/launch.py) that
each run :func:`dryrun_rank`: the fleet with Anderson (every infeasibility
flag confirmed by the LP oracle), the known-infeasible instance, the prox
fleet against the one-rank solve, the prepared sequence on a shard, the
prox block split, the block split with polish, vector rho and Anderson, the
sparse mesh against the one-rank SparseQP solve and, at an even rank count,
the 2-D mesh. It prints one summary line; any failed check raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _settings(pkg):
    return pkg.Settings(max_iterations=500, eps_abs=1e-4, eps_rel=1e-4,
                        rho=0.1, adaptive_rho=True)


def _check(cond, msg):
    if not cond:
        raise AssertionError(f"dryrun_multichip: {msg}")


def dryrun_rank(n_ranks: int, device: str) -> str:
    """One rank's share of the dry run; returns the summary line."""
    import scipy.sparse as sp
    import torch
    import torch.distributed as dist

    import quadraticprogramsolver_tpu_torch as pkg
    from ..frontends.sequence import solve_sequence_vectors
    from ..utils.feasibility import primal_feasible, verify_status_flags
    from .consensus import solve_block_split, solve_fleet_block_split
    from .mesh import make_fleet_mesh, make_mesh, shard_fleet, solve_fleet
    from .mesh import solve_prox_fleet
    from .prox_consensus import solve_prox_block_split
    from .sparse_mesh import shard_sparse_qp, solve_sparse_mesh

    _check(dist.get_world_size() == n_ranks,
           f"need {n_ranks} ranks, have {dist.get_world_size()}")
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    mesh = make_fleet_mesh(device)
    batch = 2 * n_ranks
    qp = pkg.generate_batch(pkg.ProblemClass.RANDOM_QP, batch=batch,
                            num_elements=16, seed=0, dtype=np.float32,
                            device=dev)
    # Anderson on: its per-lane histories split with the fleet like every
    # other state leaf.
    sol = solve_fleet(qp, dataclasses.replace(_settings(pkg),
                                              anderson_memory=4), mesh)
    x = sol.x.cpu().numpy()
    status = sol.info.status.cpu().numpy()
    _check(x.shape == (batch, 16), f"fleet x shape {x.shape}")
    _check(np.isfinite(x).all(), "non-finite fleet solution")
    _check((status >= 1).all(), f"fleet statuses {status}")
    # Every lane flagged infeasible must be confirmed by the host LP oracle.
    false_pos = verify_status_flags(qp.tensors(), status)
    _check(not false_pos, f"infeasibility false positives: {false_pos}")

    # One known-infeasible instance must be flagged: the equality class
    # emits a zero row with l = u != 0 at this seed. In float64 (the JAX
    # dry run's is float32): in float32 the fixed-point test's 8-ulp floor
    # can stop x at iteration 50, a check before the certificate fires (1
    # of 20 one-ulp perturbations of q on the CPU, and the card's rounding).
    data = pkg.generate_random_qp(pkg.ProblemClass.EQUALITY_QP, 20, seed=13)
    _, _, A_inf, l_inf, u_inf = data.dense()
    _check(not primal_feasible(A_inf, l_inf, u_inf),
           "the known-infeasible instance is feasible")
    inf_sol = pkg.solve(pkg.make_qp(*data.dense(), dtype=torch.float64,
                                    device=dev),
                        dataclasses.replace(_settings(pkg), max_iterations=4000,
                                            eps_abs=1e-6, eps_rel=1e-6))
    _check(int(inf_sol.info.status) == pkg.Status.PRIMAL_INFEASIBLE,
           f"known-infeasible instance flagged {int(inf_sol.info.status)}")

    # The prox-ALM family over the same mesh, against the one-rank solve.
    rngp = np.random.default_rng(7)
    pm = 12
    probs = []
    for _ in range(batch):
        Mx = rngp.standard_normal((pm, pm))
        Pp = Mx @ Mx.T + 0.5 * np.eye(pm)
        Ap = rngp.standard_normal((3, pm))
        Cp = rngp.standard_normal((5, pm))
        xf = rngp.standard_normal(pm)
        probs.append((Pp, rngp.standard_normal(pm), Ap, Ap @ xf, Cp,
                      Cp @ xf + rngp.random(5)))
    prox = pkg.make_proxqp(*(np.stack(a) for a in zip(*probs)),
                           dtype=torch.float32, device=dev)
    st_prox = pkg.ProxQPSettings(max_iterations=1000, eps_abs=1e-5,
                                 eps_rel=1e-5)
    psol_plain = pkg.solve_proxqp(prox, st_prox)
    psol = solve_prox_fleet(prox, st_prox, mesh)
    _check(bool(psol.info.converged.all()),
           f"prox fleet statuses {psol.info.status.tolist()}")
    pdev = float((psol.x - psol_plain.x).abs().max())
    _check(pdev < 1e-5, f"prox fleet off the one-rank solve by {pdev}")

    # Factor reuse on a shard: a drifting-q sequence with the prepared factor
    # against the refactoring one.
    st_seq = dataclasses.replace(_settings(pkg), adaptive_rho=False)
    qp_s = shard_fleet(pkg.generate_batch(
        pkg.ProblemClass.RANDOM_QP, batch=batch, num_elements=12, seed=5,
        dtype=np.float32, device=dev), mesh)
    drift = torch.linspace(0.0, 0.5, 3, device=dev)[:, None, None]
    q_seq = qp_s.q * (1.0 + drift)
    seq_fast = solve_sequence_vectors(qp_s, q_seq, None, None, st_seq, None,
                                      True)
    seq_slow = solve_sequence_vectors(qp_s, q_seq, None, None, st_seq, None,
                                      False)
    sdev = float((seq_fast.x - seq_slow.x).abs().max())
    _check(sdev < 1e-5, f"prepared sequence off the refactoring one by {sdev}")

    # The prox block split: one split-form QP, its rows over the ranks.
    blocks = make_mesh((n_ranks,), ("blocks",), device)
    one = dataclasses.replace(prox, **{
        f.name: getattr(prox, f.name)[0] for f in dataclasses.fields(prox)})
    st_blk = pkg.ProxQPSettings(max_iterations=1000, eps_abs=1e-5,
                                eps_rel=1e-5, kkt_warm_start=False)
    pb_plain = pkg.solve_proxqp(one, st_blk)
    pb_dist = solve_prox_block_split(one, st_blk, blocks)
    _check(bool(pb_dist.info.converged), f"prox block split status "
           f"{int(pb_dist.info.status)}")
    pb_dev = float((pb_dist.x - pb_plain.x).abs().max())
    _check(pb_dev < 1e-4, f"prox block split off the one-rank solve by {pb_dev}")

    # One box-form QP block-split, with polish, vector rho and Anderson.
    data = pkg.generate_random_qp(pkg.ProblemClass.INEQUALITY_QP, 16,
                                  num_constraints=4 * n_ranks, seed=0)
    st_bs = dataclasses.replace(_settings(pkg), polish_iterations=5,
                                rho_eq_scale=5.0, anderson_memory=4)
    dist_sol = solve_block_split(
        pkg.make_qp(*data.dense(), dtype=torch.float32, device=dev), st_bs,
        blocks)
    _check(bool(dist_sol.x.isfinite().all()), "non-finite block split")

    # One sparse QP row-split over the ranks, against the one-rank solve.
    rng = np.random.default_rng(0)
    ns = 96
    G = sp.random(ns, ns, density=0.05, random_state=rng,
                  data_rvs=rng.standard_normal, format="csr")
    Ps = (G.T @ G + 0.1 * sp.identity(ns)).tocsr()
    As = (sp.random(ns // 2, ns, density=0.05, random_state=rng,
                    data_rvs=rng.standard_normal)
          + sp.diags(np.ones(ns // 2), 0, shape=(ns // 2, ns))).tocsr()
    qv = rng.standard_normal(ns)
    lv = -(rng.random(ns // 2) + 0.5)
    uv = rng.random(ns // 2) + 0.5
    st_sp = dataclasses.replace(_settings(pkg), cg_max_iterations=200)
    rows = make_mesh((n_ranks,), ("rows",), device)
    ssq = shard_sparse_qp(Ps, qv, As, lv, uv, n_ranks, dtype=np.float32,
                          device=dev)
    msol = solve_sparse_mesh(ssq, st_sp, rows, m_orig=ns // 2)
    ref_sp = pkg.solve(pkg.make_sparse_qp(Ps, qv, As, lv, uv,
                                          dtype=np.float32, device=dev), st_sp)
    _check(int(msol.info.status) == int(ref_sp.info.status),
           f"sparse mesh status {int(msol.info.status)} vs "
           f"{int(ref_sp.info.status)}")
    sp_dev = float((msol.x - ref_sp.x).abs().max())
    _check(sp_dev < 1e-4, f"sparse mesh off the one-rank solve by {sp_dev}")

    # BASELINE config 5: the fleet x the block split on a 2-D mesh.
    status2d = -1
    if n_ranks % 2 == 0:
        mesh2d = make_mesh((2, n_ranks // 2), ("qp", "blocks"), device)
        fleet2 = pkg.generate_batch(
            pkg.ProblemClass.INEQUALITY_QP, batch=4, num_elements=16,
            num_constraints=2 * n_ranks, seed=1, dtype=np.float32, device=dev)
        d2 = solve_fleet_block_split(fleet2, _settings(pkg), mesh2d)
        _check(bool(d2.x.isfinite().all()), "non-finite 2-D mesh solution")
        status2d = int(d2.info.status.min())

    return (f"dryrun_multichip ok: {n_ranks} ranks on {device}, fleet {batch} "
            f"(statuses {np.bincount(status, minlength=4).tolist()}), "
            f"prox fleet {batch} (max dev {pdev:.1e}), prepared sequence "
            f"(max dev {sdev:.1e}), prox block split (max dev {pb_dev:.1e}), "
            f"block-split status {int(dist_sol.info.status)}, sparse mesh "
            f"(max dev {sp_dev:.1e}), 2d-mesh min status {status2d}")


def dryrun_multichip(n_ranks: int, device: str = "cuda",
                     backend: str | None = None,
                     timeout: float = 120.0) -> str:
    """Spawn ``n_ranks`` ranks on ``device`` ("cuda": rank r on card r mod
    the card count; ranks that share a card need ``backend="gloo"``), run
    the dry run on each, print and return rank 0's summary line."""
    from .launch import spawn

    lines = spawn(dryrun_rank, n_ranks, args=(n_ranks, device), device=device,
                  backend=backend, timeout=timeout)
    print(lines[0])
    return lines[0]
