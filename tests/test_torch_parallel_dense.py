"""The port's distributed dense modes (parallel/mesh.py, consensus.py,
prox_consensus.py, dryrun.py and ``CachedQPSolver(mesh=)``) against the JAX
package's, case for case with tests/test_sharding.py, test_consensus.py and
test_diagnostics.py's block-split history.

One world of 4 gloo ranks on the CPU (``parallel/launch.py: spawn``) runs
every case of this file once (a module fixture) and hands numpy results
back; every rank must return the same whole solution, bit for bit. The JAX
side runs here on 4 of the conftest's 8 virtual devices (the 2 x 2 mesh for
the 2-D cases), the same shard count. f64: statuses and iterations
identical to the JAX mesh solve, x, y, z (and s) within 1e-8 of it; where
the JAX test holds its mesh to its single-device solve, the port's mesh is
held to the port's single-device solve at the JAX test's tolerance; a
one-rank group gives the single-device solve bit for bit.
"""

import dataclasses
import operator
import threading

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import Mesh

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.models import admm as jadmm
from quadraticprogramsolver_tpu.models import proxqp as jprox
from quadraticprogramsolver_tpu.parallel import consensus as jcons
from quadraticprogramsolver_tpu.parallel import mesh as jmesh
from quadraticprogramsolver_tpu.parallel import prox_consensus as jpcons
from quadraticprogramsolver_tpu.utils.oracle import kkt_optimality

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.frontends.reuse import CachedQPSolver
from quadraticprogramsolver_tpu_torch.models import admm as padmm
from quadraticprogramsolver_tpu_torch.models import proxqp as pprox
from quadraticprogramsolver_tpu_torch.parallel import consensus as pcons
from quadraticprogramsolver_tpu_torch.parallel import mesh as pmesh
from quadraticprogramsolver_tpu_torch.parallel import prox_consensus as ppcons
from quadraticprogramsolver_tpu_torch.parallel.dryrun import dryrun_multichip
from quadraticprogramsolver_tpu_torch.parallel.launch import (Call, Ref,
                                                              run_calls, spawn)
from quadraticprogramsolver_tpu_torch.utils.interop import (
    prox_settings_from_dict, settings_from_dict)

WORLD = 4
TOL = 1e-8          # the port's mesh against the JAX mesh (f64)
FLEET = ((WORLD,), ("qp",))
BLOCKS = ((WORLD,), ("blocks",))
GRID = ((2, 2), ("qp", "blocks"))
ONE = ((WORLD, 1), ("x", "qp"))  # a one-rank "qp" group on every rank

SETTINGS = qps.Settings(max_iterations=2000, eps_abs=1e-8, eps_rel=1e-8,
                        rho=0.1)
STATIC = dataclasses.replace(SETTINGS, adaptive_rho=False)
CONS = qps.Settings(max_iterations=5000, eps_abs=1e-8, eps_rel=1e-8, rho=0.1,
                    adaptive_rho=True)
HIST = qps.Settings(max_iterations=250, eps_abs=1e-8, eps_rel=1e-8, rho=0.1,
                    adaptive_rho=True, record_history=True, check_interval=25)


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _pst(st):
    if isinstance(st, qps.ProxQPSettings):
        return prox_settings_from_dict(dataclasses.asdict(st))
    return settings_from_dict(dataclasses.asdict(st))


def _arrays(qp):
    return [np.asarray(t) for t in (qp.P, qp.q, qp.A, qp.l, qp.u)]


def _box(qp_j):
    """The port's CPU QP of a JAX QP's arrays."""
    return pt.make_qp(*_arrays(qp_j), device="cpu")


def _fleet(cls, batch, n, m=0, seed=0, dtype=np.float64):
    qp_j = qps.generate_batch(cls, batch=batch, num_elements=n,
                              num_constraints=m, seed=seed, dtype=dtype)
    return qp_j, _box(qp_j)


def _one(cls, n, m=0, seed=0):
    data = qps.generate_random_qp(cls, n, num_constraints=m, seed=seed)
    qp_j = qps.make_qp(*data.dense(), dtype=np.float64)
    return data, qp_j, _box(qp_j)


def _prox_arrays(batch=16, n=20, me=4, mi=8, seed0=0):
    """tests/test_sharding.py's prox fleet, as stacked numpy arrays."""
    out = []
    for s in range(seed0, seed0 + batch):
        rng = np.random.default_rng(s)
        M = rng.standard_normal((n, n))
        P = M @ M.T + 0.5 * np.eye(n)
        q = rng.standard_normal(n)
        A = rng.standard_normal((me, n))
        C = rng.standard_normal((mi, n))
        x_feas = rng.standard_normal(n)
        out.append((P, q, A, A @ x_feas, C, C @ x_feas + rng.random(mi)))
    return [np.stack(a) for a in zip(*out)]


def _prox_fleet(**kw):
    arrays = _prox_arrays(**kw)
    return (qps.make_proxqp(*arrays, dtype=np.float64),
            pt.make_proxqp(*arrays, device="cpu"))


def _prox_one(seed, n, me, mi, shift=0.0):
    """One split-form QP as tests/test_sharding.py's block-split cases make
    it (``shift`` adds slack to the inequalities)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    P_ = M @ M.T + 0.5 * np.eye(n)
    A = rng.standard_normal((me, n))
    C = rng.standard_normal((mi, n))
    xf = rng.standard_normal(n)
    arrays = (P_, rng.standard_normal(n), A, A @ xf, C,
              C @ xf + rng.random(mi) + shift)
    return (qps.make_proxqp(*arrays, dtype=np.float64),
            pt.make_proxqp(*arrays, device="cpu"))


def _random_shape_case(trial):
    """tests/test_sharding.py: test_prox_block_split_random_shapes' draw."""
    rng = np.random.default_rng(1000 + trial)
    n = int(rng.integers(8, 40))
    me = int(rng.integers(1, max(2, n // 3)))
    mi = int(rng.integers(1, n))
    M = rng.standard_normal((n, n))
    P_ = M @ M.T + (0.3 + rng.random()) * np.eye(n)
    A = rng.standard_normal((me, n))
    C = rng.standard_normal((mi, n))
    xf = rng.standard_normal(n)
    arrays = (P_, rng.standard_normal(n), A, A @ xf, C,
              C @ xf + rng.random(mi) + 0.1)
    st = qps.ProxQPSettings(max_iterations=3000, eps_abs=1e-8, eps_rel=1e-8,
                            kkt_warm_start=False,
                            adaptive_rho=bool(rng.integers(2)),
                            rho=float(10 ** rng.uniform(-3, 1)))
    return (qps.make_proxqp(*arrays, dtype=np.float64),
            pt.make_proxqp(*arrays, device="cpu"), st)


def _infeasible_prox():
    rng = np.random.default_rng(8)
    n, mi = 16, 8
    row = rng.standard_normal(n)
    A = np.stack([row, row])
    b = np.array([1.0, -1.0])        # row.x = 1 AND row.x = -1
    C = rng.standard_normal((mi, n))
    d = C @ rng.standard_normal(n) + 1.0
    arrays = (np.eye(n), rng.standard_normal(n), A, b, C, d)
    return (qps.make_proxqp(*arrays, dtype=np.float64),
            pt.make_proxqp(*arrays, device="cpu"))


# ---------------------------------------------------------------------------
# The cases: each is (its calls on every rank, its single-rank calls, the
# inputs its test needs). Single-rank calls (no collectives) run after every
# case's world calls, spread over the ranks.


def _solve_pair(entry, qp_t, st, mesh, single=pt.solve, **kw):
    return ([Call(entry, (qp_t, st), kw, mesh=mesh)],
            [Call(single, (qp_t, st))])


def _cases():
    c = {}
    c["world"] = ([Call(dist.get_world_size)], [], {})

    qp_j, qp_t = _fleet(qps.ProblemClass.RANDOM_QP, 16, 20)
    c["fleet"] = _solve_pair(pmesh.solve_fleet, qp_t, _pst(SETTINGS), FLEET) \
        + ({"qp": qp_j},)
    c["fleet_one_rank"] = (
        [Call(pmesh.solve_fleet, (qp_t, _pst(SETTINGS)), mesh=ONE),
         Call(pt.solve, (qp_t, _pst(SETTINGS)))], [], {})

    qp_j8, qp_t8 = _fleet(qps.ProblemClass.RANDOM_QP, 8, 10, seed=1,
                          dtype=np.float32)
    c["placement"] = ([Call(pmesh.shard_fleet, (qp_t8,), mesh=FLEET)], [],
                      {"qp": qp_t8})
    _, qp_t6 = _fleet(qps.ProblemClass.RANDOM_QP, 6, 10, seed=1,
                      dtype=np.float32)
    c["indivisible"] = ([Call(pmesh.shard_fleet, (qp_t6,), mesh=FLEET)], [],
                        {})

    st = _pst(STATIC)
    c["prepared"] = (
        [Call(pmesh.shard_fleet, (qp_t,), mesh=FLEET, out=False),
         Call(padmm.prepare, (Ref(0), st)),
         Call(pmesh.solve_fleet, (qp_t, st), {"prepared": Ref(1)},
              mesh=FLEET)],
        [Call(padmm.prepare, (qp_t, st), out=False),
         Call(pt.solve, (qp_t, st), {"prepared": Ref(0)})],
        {"qp": qp_j})

    qp_j3, qp_t3 = _fleet(qps.ProblemClass.RANDOM_QP, 16, 20, seed=3)
    q2 = np.asarray(qp_j3.q) * 0.5
    c["cached"] = (
        [Call(CachedQPSolver, (qp_t3, st), mesh=FLEET, out=False),
         Call(CachedQPSolver.solve, (Ref(0),)),
         Call(CachedQPSolver.update, (Ref(0),), {"q": q2}),
         Call(operator.attrgetter("qp"), (Ref(0),)),
         Call(CachedQPSolver.solve, (Ref(0),), {"warm_start": True})],
        [Call(CachedQPSolver, (qp_t3, st), out=False),
         Call(CachedQPSolver.solve, (Ref(0),)),
         Call(CachedQPSolver.update, (Ref(0),), {"q": q2}),
         Call(CachedQPSolver.solve, (Ref(0),), {"warm_start": True})],
        {"qp": qp_j3, "q2": q2})

    pst = qps.ProxQPSettings(max_iterations=2000, eps_abs=1e-9, eps_rel=1e-9)
    prob_j, prob_t = _prox_fleet(batch=8, seed0=40)
    c["prox_prepared"] = (
        [Call(pmesh.shard_fleet, (prob_t,), mesh=FLEET, out=False),
         Call(pprox.prepare, (Ref(0), _pst(pst))),
         Call(pmesh.solve_prox_fleet, (prob_t, _pst(pst)),
              {"prepared": Ref(1)}, mesh=FLEET)],
        [Call(pprox.prepare, (prob_t, _pst(pst)), out=False),
         Call(pt.solve_proxqp, (prob_t, _pst(pst)), {"prepared": Ref(0)})],
        {"prob": prob_j, "st": pst})

    prob_j16, prob_t16 = _prox_fleet()
    c["prox_fleet"] = _solve_pair(pmesh.solve_prox_fleet, prob_t16,
                                  _pst(pst), FLEET, pt.solve_proxqp) \
        + ({"prob": prob_j16, "st": pst},)
    c["prox_fleet_one_rank"] = (
        [Call(pmesh.solve_prox_fleet, (prob_t16, _pst(pst)), mesh=ONE),
         Call(pt.solve_proxqp, (prob_t16, _pst(pst)))], [], {})
    sf = qps.ProxQPSettings(max_iterations=1000, eps_abs=1e-7, eps_rel=1e-7,
                            sigma_free_rhs=True, kkt_refinement_steps=0,
                            anderson_memory=4)
    prob_jsf, prob_tsf = _prox_fleet(batch=8, seed0=100)
    c["prox_sf_aa"] = _solve_pair(pmesh.solve_prox_fleet, prob_tsf, _pst(sf),
                                  FLEET, pt.solve_proxqp) \
        + ({"prob": prob_jsf, "st": sf},)
    _, prob_t8 = _prox_fleet(batch=8)
    c["prox_placement"] = ([Call(pmesh.shard_fleet, (prob_t8,), mesh=FLEET)],
                           [], {"prob": prob_t8})

    blk = qps.ProxQPSettings(max_iterations=2000, eps_abs=1e-9, eps_rel=1e-9,
                             kkt_warm_start=False)
    for name, (pj, ptt), st_b in (
            ("pbs_match", _prox_one(42, 24, 8, 16), blk),
            ("pbs_adaptive", _prox_one(21, 24, 8, 16), dataclasses.replace(
                blk, rho=1e-4, adaptive_rho=True, record_history=True)),
            ("pbs_infeasible", _infeasible_prox(), blk),
            ("pbs_padding", _prox_one(11, 16, 3, 5), dataclasses.replace(
                blk, eps_abs=1e-8, eps_rel=1e-8))):
        c[name] = _solve_pair(ppcons.solve_prox_block_split, ptt, _pst(st_b),
                              BLOCKS, pt.solve_proxqp) \
            + ({"prob": pj, "st": st_b},)
    for trial in (0, 1, 2, 5):
        pj, ptt, st_b = _random_shape_case(trial)
        c[f"pbs_random_{trial}"] = _solve_pair(
            ppcons.solve_prox_block_split, ptt, _pst(st_b), BLOCKS,
            pt.solve_proxqp) + ({"prob": pj, "st": st_b},)

    # tests/test_consensus.py
    for name, (cls, n, m, seed), st_c in (
            ("bs_match", (qps.ProblemClass.INEQUALITY_QP, 32, 64, 0), CONS),
            ("bs_kkt", (qps.ProblemClass.INEQUALITY_QP, 32, 64, 1), CONS),
            ("bs_padding", (qps.ProblemClass.INEQUALITY_QP, 16, 30, 2), CONS),
            ("bs_polish", (qps.ProblemClass.INEQUALITY_QP, 32, 64, 3),
             qps.Settings(max_iterations=2000, eps_abs=1e-5, eps_rel=1e-5,
                          rho=0.1, adaptive_rho=True, polish_iterations=10)),
            ("bs_vector_rho", (qps.ProblemClass.RANDOM_QP, 32, 0, 4),
             dataclasses.replace(CONS, rho_eq_scale=10.0)),
            ("bs_infeasible", (qps.ProblemClass.EQUALITY_QP, 20, 0, 13),
             qps.Settings(max_iterations=2000, rho=0.1, adaptive_rho=True)),
            ("bs_anderson", (qps.ProblemClass.INEQUALITY_QP, 32, 64, 3),
             dataclasses.replace(CONS, anderson_memory=8)),
            ("bs_history", (qps.ProblemClass.RANDOM_QP, 24, 0, 2), HIST)):
        data, qj, qt = _one(cls, n, m, seed)
        world, single = _solve_pair(pcons.solve_block_split, qt,
                                       _pst(st_c), BLOCKS)
        if name == "bs_anderson":  # and the unaccelerated block split
            world.append(Call(pcons.solve_block_split, (qt, _pst(CONS)),
                              mesh=BLOCKS))
        c[name] = (world, single, {"data": data, "qp": qj, "st": st_c})
    for name, (batch, n, m, seed) in (("fbs_2d", (4, 24, 32, 5)),
                                      ("fbs_padding", (2, 16, 30, 2))):
        qj, qt = _fleet(qps.ProblemClass.INEQUALITY_QP, batch, n, m, seed)
        c[name] = _solve_pair(pcons.solve_fleet_block_split, qt, _pst(CONS),
                              GRID) + ({"qp": qj, "st": CONS},)
    qj, qt = _fleet(qps.ProblemClass.RANDOM_QP, 4, 24, seed=0)
    c["fbs_history"] = ([Call(pcons.solve_fleet_block_split, (qt, _pst(HIST)),
                              mesh=GRID)], [], {"qp": qj, "st": HIST})
    return c


def _same_bits(a, b, where):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_bits(a[k], b[k], f"{where}.{k}")
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same_bits(getattr(a, f.name), getattr(b, f.name),
                       f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        for i, (u, v) in enumerate(zip(a, b)):
            _same_bits(u, v, f"{where}[{i}]")
    else:
        assert a == b, where


#: World calls whose value is the rank's own shard (not checked equal over
#: the ranks): (case, call index).
RANK_LOCAL = {("placement", 0), ("prepared", 1), ("cached", 3),
              ("prox_prepared", 1), ("prox_placement", 0)}


def _jax_prepared(inp):
    sq = jmesh.shard_fleet(inp["qp"], _jax_mesh(*FLEET))
    prep = jadmm.prepare_jit(sq, STATIC)
    return qps.solve_jit(sq, STATIC, None, None, None, None, None, prep)


def _jax_cached(inp):
    solver = qps.CachedQPSolver(inp["qp"], STATIC, mesh=_jax_mesh(*FLEET))
    first = solver.solve()
    solver.update(q=inp["q2"])
    return first, solver.solve(warm_start=True)


def _jax_prox_prepared(inp):
    sp_ = jmesh.shard_fleet(inp["prob"], _jax_mesh(*FLEET))
    prep = jprox.prepare_jit(sp_, inp["st"])
    return qps.solve_proxqp_jit(sp_, inp["st"], None, None, prep)


def _jax_ref(name, inp):
    """The JAX mesh solve (or solves) that case ``name`` is held to."""
    if name == "fleet":
        return jmesh.solve_fleet(inp["qp"], SETTINGS, _jax_mesh(*FLEET))
    if name == "prepared":
        return _jax_prepared(inp)
    if name == "cached":
        return _jax_cached(inp)
    if name == "prox_prepared":
        return _jax_prox_prepared(inp)
    if name in ("prox_fleet", "prox_sf_aa"):
        return jmesh.solve_prox_fleet(inp["prob"], inp["st"],
                                      _jax_mesh(*FLEET))
    if name.startswith("pbs_"):
        return jpcons.solve_prox_block_split(inp["prob"], inp["st"],
                                             _jax_mesh(*BLOCKS))
    if name.startswith("bs_"):
        return jcons.solve_block_split(inp["qp"], inp["st"],
                                       _jax_mesh(*BLOCKS))
    if name.startswith("fbs_"):
        return jcons.solve_fleet_block_split(inp["qp"], inp["st"],
                                             _jax_mesh(*GRID))
    return None


@dataclasses.dataclass
class Case:
    res: list        # rank 0's world results, (ok, value) a call
    single: list     # the single-rank calls' results
    inp: dict        # the inputs, for the JAX side
    every: list      # every rank's world results
    ref: object      # the JAX mesh solve(s), or None


def run_cases(cases):
    """Run ``cases`` ({name: (world calls, single calls, ...)}, each Ref
    counting within its own list) in one world of WORLD gloo ranks on the
    CPU: every case's world calls first, in order, on every rank, then each
    case's single calls (no collectives) on one rank, the cases dealt round
    the ranks so that their solves overlap. Returns {name: (every rank's
    world results, the owner's single results)}, results as run_calls
    gives them."""
    def shifted(call, base, rank=None):
        def at(v):
            return Ref(v.index + base) if isinstance(v, Ref) else v

        return dataclasses.replace(
            call, args=tuple(at(a) for a in call.args),
            kwargs={k: at(v) for k, v in call.kwargs.items()}, rank=rank)

    flat, spans, singles = [], {}, {}
    for name, (calls, _, *_) in cases.items():
        spans[name] = (len(flat), len(calls))
        flat += [shifted(c, len(flat)) for c in calls]
    owner = 0
    for name, (_, calls, *_) in cases.items():
        if calls:
            singles[name] = (len(flat), len(calls), owner)
            flat += [shifted(c, singles[name][0], owner) for c in calls]
            owner = (owner + 1) % WORLD
    ranks = spawn(run_calls, WORLD, args=(flat,),
                  kwargs={"device": "cpu", "timeout": 60.0}, device="cpu",
                  timeout=60.0, deadline=600.0)
    out = {}
    for name, (a, k) in spans.items():
        single = []
        if name in singles:
            b, k1, rank = singles[name]
            single = ranks[rank][b:b + k1]
        out[name] = ([r[a:a + k] for r in ranks], single)
    return out


def run_world(cases, jax_ref, rank_local=frozenset()):
    """Run ``cases`` ({name: (world calls, single calls, inputs)}) in one
    world (:func:`run_cases`), in a thread, while ``jax_ref(name, inputs)``
    solves each JAX reference here; returns {name: Case}. A world call's
    value is rank 0's, checked equal to every other rank's bit for bit but
    for the ``rank_local`` (case, call index) pairs, whose value is the
    rank's own shard. Shared with tests/test_torch_parallel_sparse.py."""
    box = {}

    def run():
        try:
            box["out"] = run_cases(cases)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e

    thread = threading.Thread(target=run)
    thread.start()
    try:
        refs = {name: jax_ref(name, v[2]) for name, v in cases.items()}
    finally:
        thread.join()
    if "err" in box:
        raise box["err"]
    out = {}
    for name, (every, single) in box["out"].items():
        for r in range(1, WORLD):
            for j, ((ok0, v0), (ok, v)) in enumerate(zip(every[0], every[r])):
                assert ok == ok0, (name, j, r)
                if ok and (name, j) not in rank_local:
                    _same_bits(v0, v, f"{name}[{j}] rank {r}")
        out[name] = Case(every[0], single, cases[name][2], every, refs[name])
    return out


@pytest.fixture(scope="module")
def world():
    """Every case's results (:class:`Case`)."""
    return run_world(_cases(), _jax_ref, RANK_LOCAL)


def _ok(results, j=0):
    ok, value = results[j]
    assert ok, value
    return value


def _close(sol, ref, tol, names=("x", "y", "z")):
    """Each named leaf within tol of the reference's, lane by lane, relative
    to the lane's largest entry where that is above 1. A lane flagged
    infeasible (status 4 or 5) holds its y to 1e-6 of that scale instead:
    its dual is the certificate's direction and grows with every iteration
    (8e3 and 4e7 in the fleet case), and the port's single-card solve and
    JAX's already differ there by 1.1e-8 of it."""
    status = np.atleast_1d(np.asarray(ref.info.status))
    for name in names:
        a, b = np.asarray(getattr(sol, name)), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if not a.size:
            continue
        a2, b2 = a.reshape(status.size, -1), b.reshape(status.size, -1)
        scale = np.maximum(np.abs(b2).max(-1), 1.0)
        dev = np.abs(a2 - b2).max(-1) / scale
        bar = np.where((status >= 4) & (name == "y"), 1e-6, tol)
        assert (dev <= bar).all(), (name, dev.max())


def _same_run(sol, ref, names=("x", "y", "z"), tol=TOL):
    """Statuses and iterations identical, the named leaves within tol."""
    np.testing.assert_array_equal(np.asarray(sol.info.status),
                                  np.asarray(ref.info.status))
    np.testing.assert_array_equal(np.asarray(sol.info.iterations),
                                  np.asarray(ref.info.iterations))
    _close(sol, ref, tol, names)


# ---------------------------------------------------------------------------
# tests/test_sharding.py


def test_world_has_four_ranks(world):
    assert _ok(world["world"].res) == WORLD


def test_sharded_fleet_matches_single_device(world):
    case = world["fleet"]
    sol, plain = _ok(case.res), _ok(case.single)
    _same_run(sol, case.ref)
    np.testing.assert_array_equal(sol.info.status, plain.info.status)
    _close(sol, plain, 1e-10, ("x",))


def test_one_rank_group_is_the_single_device_solve(world):
    for name in ("fleet_one_rank", "prox_fleet_one_rank"):
        res = world[name].res
        _same_bits(_ok(res, 0), _ok(res, 1), name)


def test_shard_placement(world):
    case = world["placement"]
    for r, res in enumerate(case.every):
        shard = _ok(res)
        # Each leaf's leading axis is split 4 ways: rank r holds lanes
        # 2r and 2r + 1.
        assert shard.P.shape == (2, 10, 10)
        np.testing.assert_array_equal(shard.P,
                                      case.inp["qp"].P[2 * r:2 * r + 2].numpy())


def test_indivisible_fleet_rejected(world):
    ok, err = world["indivisible"].res[0]
    assert not ok and "not divisible" in err


def test_prepared_factor_shards_with_fleet(world):
    case = world["prepared"]
    prep, sol = _ok(case.res, 1), _ok(case.res, 2)
    # The factor is the rank's shard's.
    assert prep.cache["M_inv"].shape == (4, 20, 20)
    ref = _ok(case.single, 1)
    _close(sol, ref, 1e-10, ("x",))
    np.testing.assert_array_equal(sol.info.status, ref.info.status)
    _same_run(sol, case.ref)


def test_cached_solver_on_mesh(world):
    case = world["cached"]
    s1, s2 = _ok(case.res, 1), _ok(case.res, 4)
    r1, r2 = _ok(case.single, 1), _ok(case.single, 3)
    _close(s1, r1, 1e-10, ("x",))
    # The updated q is each rank's share of the fleet-wide one.
    for r, every in enumerate(case.every):
        local = _ok(every, 3)
        assert local.q.shape == (4, 20)
        np.testing.assert_array_equal(local.q, case.inp["q2"][4 * r:4 * r + 4])
    _close(s2, r2, 1e-10, ("x",))
    _same_run(s1, case.ref[0])
    _same_run(s2, case.ref[1])


def test_prox_prepared_shards_with_fleet(world):
    case = world["prox_prepared"]
    prep, sol = _ok(case.res, 1), _ok(case.res, 2)
    assert prep.cache.shape == (2, 20, 20)
    ref = _ok(case.single, 1)
    _close(sol, ref, 1e-10, ("x",))
    np.testing.assert_array_equal(sol.info.status, ref.info.status)
    _same_run(sol, case.ref, ("x", "y", "z", "s"))


def test_prox_fleet_matches_single_device(world):
    case = world["prox_fleet"]
    sol, plain = _ok(case.res), _ok(case.single)
    assert sol.info.converged.all()
    _same_run(sol, plain, ("x", "y", "z", "s"), 1e-10)
    _same_run(sol, case.ref, ("x", "y", "z", "s"))


def test_prox_fleet_sigma_free_and_anderson_shard(world):
    case = world["prox_sf_aa"]
    sol, plain = _ok(case.res), _ok(case.single)
    _close(sol, plain, 1e-10, ("x",))
    np.testing.assert_array_equal(sol.info.status, plain.info.status)
    _same_run(sol, case.ref, ("x", "y", "z", "s"))


def test_prox_shard_placement(world):
    case = world["prox_placement"]
    for r, res in enumerate(case.every):
        shard = _ok(res)
        assert shard.P.shape == (2, 20, 20)
        assert shard.C.shape == (2, 8, 20)
        np.testing.assert_array_equal(
            shard.C, case.inp["prob"].C[2 * r:2 * r + 2].numpy())


def _prox_block(world, name):
    case = world[name]
    sol, plain = _ok(case.res), _ok(case.single)
    _same_run(sol, case.ref, ("x", "y", "z", "s"))
    return sol, plain, case.ref


def test_prox_block_split_matches_single_device(world):
    sol, plain, _ = _prox_block(world, "pbs_match")
    assert bool(sol.info.converged) and bool(plain.info.converged)
    assert int(sol.info.iterations) == int(plain.info.iterations)
    _close(sol, plain, 1e-8, ("x", "y", "z", "s"))


def test_prox_block_split_adaptive_rho_and_history(world):
    sol, plain, ref = _prox_block(world, "pbs_adaptive")
    assert bool(sol.info.converged)
    assert float(sol.info.rho) > 1e-4  # adaptation really tripped
    assert abs(float(plain.info.rho) - float(sol.info.rho)) < 1e-9
    assert int(plain.info.iterations) == int(sol.info.iterations)
    _close(sol, plain, 1e-8, ("x",))
    # The same checks ran; the residual traces agree to 1e-8 relative above
    # 1e-12 (the last checks' residuals of ~3e-10 carry ~5e-15 of rounding)
    # and the rho trace to 1e-9, the final rho's bar (JAX's own mesh and
    # single-device traces, one compiler apart, agree to 1e-12).
    for h in (plain.info.history, ref.info.history):
        ran = np.isfinite(np.asarray(h["res_prim"]))
        np.testing.assert_array_equal(ran, np.isfinite(
            sol.info.history["res_prim"]))
        np.testing.assert_allclose(sol.info.history["res_prim"][ran],
                                   np.asarray(h["res_prim"])[ran], rtol=1e-8,
                                   atol=1e-12)
        np.testing.assert_allclose(sol.info.history["rho"][ran],
                                   np.asarray(h["rho"])[ran], rtol=1e-9)


def test_prox_block_split_detects_infeasible(world):
    sol, plain, _ = _prox_block(world, "pbs_infeasible")
    assert int(plain.info.status) == qps.Status.PRIMAL_INFEASIBLE
    assert int(sol.info.status) == qps.Status.PRIMAL_INFEASIBLE


@pytest.mark.parametrize("trial", [0, 1, 2, 5])
def test_prox_block_split_random_shapes(world, trial):
    sol, plain, _ = _prox_block(world, f"pbs_random_{trial}")
    assert int(plain.info.status) == int(sol.info.status)
    _close(sol, plain, 1e-8, ("x",))


def test_prox_block_split_row_padding(world):
    sol, plain, _ = _prox_block(world, "pbs_padding")
    assert bool(sol.info.converged)
    assert sol.y.shape == (3,) and sol.z.shape == (5,)
    _close(sol, plain, 1e-8, ("x",))


def test_dryrun_multichip():
    line = dryrun_multichip(WORLD, device="cpu")
    assert line.startswith(f"dryrun_multichip ok: {WORLD} ranks on cpu")


# ---------------------------------------------------------------------------
# tests/test_consensus.py and test_diagnostics.py: test_block_split_history


def _block(world, name, plain_tol=1e-9):
    """The port's block split against the JAX one on 4 row blocks (same
    run, TOL) and its single-device solve (statuses and iterations, x within
    the JAX test's ``plain_tol``); returns the port's solution."""
    case = world[name]
    sol, plain = _ok(case.res), _ok(case.single)
    _same_run(sol, case.ref)
    assert int(sol.info.status) == int(plain.info.status)
    assert int(sol.info.iterations) == int(plain.info.iterations)
    _close(sol, plain, plain_tol, ("x",))
    return sol, case


def test_block_split_matches_single_device(world):
    _block(world, "bs_match")


def test_block_split_kkt_optimal(world):
    sol, case = _block(world, "bs_kkt")
    d = case.inp["data"]
    rep = kkt_optimality(d.P, d.q, d.A, d.l, d.u, sol.x, sol.z, sol.y)
    assert rep.res_prim <= 1e-6 and rep.res_dual <= 1e-6


def test_block_split_row_padding(world):
    _block(world, "bs_padding")


def test_block_split_rejects_batched():
    _, fleet = _fleet(qps.ProblemClass.RANDOM_QP, 4, 10)
    with pytest.raises(ValueError, match="unbatched"):
        pcons.solve_block_split(fleet, _pst(CONS))


def _fleet_block(world, name):
    case = world[name]
    sol, plain = _ok(case.res), _ok(case.single)
    _same_run(sol, case.ref)
    np.testing.assert_array_equal(sol.info.status, plain.info.status)
    return sol, plain


def test_fleet_block_split_2d_mesh(world):
    sol, plain = _fleet_block(world, "fbs_2d")
    np.testing.assert_array_equal(sol.info.iterations, plain.info.iterations)
    _close(sol, plain, 1e-9, ("x",))


def test_fleet_block_split_row_padding(world):
    sol, plain = _fleet_block(world, "fbs_padding")
    _close(sol, plain, 1e-9, ("x",))


def test_block_split_polish_matches_single_device(world):
    sol, case = _block(world, "bs_polish", plain_tol=1e-7)
    d = case.inp["data"]
    rep = kkt_optimality(d.P, d.q, d.A, d.l, d.u, sol.x, sol.z, sol.y)
    assert rep.res_prim <= 1e-6 and rep.res_dual <= 1e-6


def test_block_split_vector_rho_matches_single_device(world):
    _block(world, "bs_vector_rho")


def test_block_split_returns_unpadded_duals(world):
    sol = _ok(world["bs_padding"].res)
    assert sol.z.shape == (30,) and sol.y.shape == (30,)


def test_block_split_infeasibility_certificate(world):
    sol, _ = _block(world, "bs_infeasible")
    assert int(sol.info.status) in (4, 5)


def test_block_split_anderson_matches_single_device(world):
    sol, case = _block(world, "bs_anderson", plain_tol=1e-7)
    plain_split = _ok(case.res, 1)
    assert int(sol.info.iterations) <= int(plain_split.info.iterations)


def test_block_split_history(world):
    sol, case = _block(world, "bs_history")
    h = sol.info.history
    assert h["res_prim"].shape == (HIST.num_checks,)
    rp = h["res_prim"]
    assert np.isfinite(rp).any()
    # The JAX mesh's trace check for check (the same checks ran), and the
    # port's single-device trace at the JAX test's bar.
    for k in ("res_prim", "res_dual", "rho"):
        a = np.asarray(case.ref.info.history[k])
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(h[k]))
        both = np.isfinite(a)
        np.testing.assert_allclose(h[k][both], a[both], rtol=1e-5,
                                   atol=1e-12)
    plain = _ok(case.single).info.history["res_prim"]
    both = np.isfinite(plain) & np.isfinite(rp)
    np.testing.assert_allclose(rp[both], plain[both], rtol=1e-5, atol=1e-12)
    # Fleet x blocks on the 2-D mesh: the history carries the fleet axis,
    # and each fleet shard stops at its own last check, as in JAX.
    fcase = world["fbs_history"]
    fh = _ok(fcase.res).info.history["res_prim"]
    assert fh.shape == (HIST.num_checks, 4)
    ja = np.asarray(fcase.ref.info.history["res_prim"])
    np.testing.assert_array_equal(np.isfinite(ja), np.isfinite(fh))
    np.testing.assert_allclose(fh[np.isfinite(ja)], ja[np.isfinite(ja)],
                               rtol=1e-5, atol=1e-12)
