"""The port's matrix-free prox path (SparseProxQP, make_sparse_proxqp,
warm_start_operator, the operator branch of the prox solve and its plan),
the smoothing application's operator builders and ``spsd_sqrt``, against
the JAX package (after its tests/test_proxqp.py:261-530 and
tests/test_operators.py).

f64 on the CPU, the same numpy and scipy inputs (from a seed) to both.
Tolerances: builders bit for bit; operators within 1e-12; spsd_sqrt within
1e-10 (M'M, and M's rows up to the eigenvectors' signs); warm starts within
1e-10; whole solves identical statuses and iteration counts with x, y, s and
z within 1e-8 (the inner CG stops at cg_eps, so the two packages' iterates
differ at the order of its rounding, not of eps).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.models import plan as jplan
from quadraticprogramsolver_tpu.models import proxqp as jprox
from quadraticprogramsolver_tpu.ops.linalg import spsd_sqrt as jax_spsd_sqrt
from quadraticprogramsolver_tpu.problems import operators as jops

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.models import kkt as pkkt
from quadraticprogramsolver_tpu_torch.models import proxqp as pprox
from quadraticprogramsolver_tpu_torch.ops.linalg import spsd_sqrt
from quadraticprogramsolver_tpu_torch.problems import operators as pops
from quadraticprogramsolver_tpu_torch.utils.interop import (
    prox_settings_from_dict)

SOLVE_TOL = 1e-8
FIELDS = ("P", "A", "At", "C", "Ct")


def _pst(st):
    return prox_settings_from_dict(dataclasses.asdict(st))


def _same(sol, ref, tol=SOLVE_TOL):
    assert int(sol.info.status) == int(ref.info.status)
    assert int(sol.info.iterations) == int(ref.info.iterations)
    for name in ("x", "y", "s", "z"):
        dev = np.abs(getattr(sol, name).numpy()
                     - np.asarray(getattr(ref, name))).max(initial=0.0)
        assert dev <= tol, (name, dev)


def _split_problem(n=60, me=10, mi=30, seed=3):
    """tests/test_proxqp.py:316-345's sparse split QP (scipy CSR)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2)
    P = W @ W.T + 0.5 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((me, n)) * (rng.random((me, n)) < 0.3)
    b = A @ rng.standard_normal(n)
    C = rng.standard_normal((mi, n)) * (rng.random((mi, n)) < 0.3)
    d = C @ rng.standard_normal(n) + 1.0
    return (sp.csr_matrix(P), q, sp.csr_matrix(A), b, sp.csr_matrix(C), d)


def _smoothing(n=400, step=25, lam=10.0, seed=0, period=4 * np.pi,
               fn=np.sin):
    """tests/test_proxqp.py:283-313's monotone smoothing with x[0] pinned."""
    rng = np.random.default_rng(seed)
    y = fn(np.linspace(0, period, n)) + 0.1 * rng.standard_normal(n)
    P, q, C, d = jops.monotone_smoothing_qp(y, np.arange(0, n, step),
                                            smooth_order=2, lam=lam)
    A = np.zeros((1, n))
    A[0, 0] = 1.0
    return (sp.csr_matrix(P), q, sp.csr_matrix(A), np.array([y[0]]),
            sp.csr_matrix(C), d)


def _pair(args, dtype=np.float64, storage="ell"):
    return (qps.make_sparse_proxqp(*args, dtype=dtype),
            pt.make_sparse_proxqp(*args, dtype=dtype, storage=storage,
                                  device="cpu"))


# ---------------------------------------------------------------- builders

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_make_sparse_proxqp_ell_fields_match_jax(dtype):
    j, p = _pair(_split_problem(), dtype)
    for f in FIELDS:
        for part in ("vals", "cols"):
            a = np.asarray(getattr(j, f"{f}_{part}"))
            b = getattr(p, f"{f}_{part}").numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (f, part)
    for f in ("q", "b", "d", "dP", "dAtA", "dCtC"):
        a, b = np.asarray(getattr(j, f)), getattr(p, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (p.n, p.n_eq, p.n_ineq, p.batch_shape, p.is_dense) == (
        j.n, j.n_eq, j.n_ineq, (), False)
    assert p.device.type == "cpu" and p.P_csr is None


@pytest.mark.parametrize("storage", ["ell", "bcoo"])
def test_sparse_proxqp_operators_match_jax(storage):
    """Every product and diagonal of the operator protocol, ELL or CSR,
    against JAX's ELL operators within 1e-12."""
    j, p = _pair(_split_problem(), storage=storage)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(p.n)
    w_e, w_i = rng.standard_normal(p.n_eq), rng.standard_normal(p.n_ineq)
    for name, arg in (("matvec_P", v), ("matvec_A", v), ("matvec_At", w_e),
                      ("matvec_C", v), ("matvec_Ct", w_i)):
        a = np.asarray(getattr(j, name)(jnp.asarray(arg)))
        b = getattr(p, name)(torch.tensor(arg)).numpy()
        assert np.abs(a - b).max() <= 1e-12, name
    for name in ("diag_P", "diag_AtA", "diag_CtC"):
        assert np.array_equal(np.asarray(getattr(j, name)()),
                              getattr(p, name)().numpy()), name
    if storage == "bcoo":
        assert p.P_vals is None and p.Ct_csr.layout == torch.sparse_csr


def test_make_sparse_proxqp_device_and_arguments(monkeypatch):
    args = _split_problem(n=20, me=3, mi=5)
    with pytest.raises(ValueError, match="storage"):
        pt.make_sparse_proxqp(*args, storage="coo", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        pt.make_sparse_proxqp(*args, dtype=np.float16, device="cpu")
    q = pt.make_sparse_proxqp(*args, dtype=torch.float32, device="cpu")
    assert q.dtype == torch.float32 and q.C_cols.dtype == torch.int32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.make_sparse_proxqp(*args)


# ------------------------------------------------------------- warm start

@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_warm_start_operator_matches_jax(form):
    """x0 = (P + sigma I)^{-1}(-q) by Jacobi-CG, s = max(d - C x0, 0),
    y = z = 0; on a SparseProxQP and (as JAX allows) a dense problem."""
    args = _smoothing()
    if form == "sparse":
        j, p = _pair(args)
    else:
        dense = [a.toarray() if sp.issparse(a) else a for a in args]
        j = qps.make_proxqp(*dense, dtype=np.float64)
        p = pt.make_proxqp(*dense, device="cpu")
    st = qps.ProxQPSettings(cg_eps=1e-12, cg_max_iterations=400)
    steps = pkkt._pcg.steps
    got = pprox.warm_start_operator(p, _pst(st))
    assert pkkt._pcg.steps > steps
    for a, b in zip(got, jprox.warm_start_operator(j, st)):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.abs(a.numpy() - np.asarray(b)).max(initial=0.0) <= 1e-10


# --------------------------------------------------------------- solves

SMOOTH_SETTINGS = qps.ProxQPSettings(max_iterations=2000, eps_abs=1e-9,
                                     eps_rel=1e-8, cg_eps=1e-12,
                                     cg_max_iterations=400,
                                     kkt_warm_start=False)


@pytest.fixture(scope="module")
def smooth():
    """The n = 400 smoothing problem, JAX's sparse solve of it and the
    port's ELL solve with its CG steps and syncs, shared."""
    args = _smoothing()
    j, p = _pair(args)
    steps, syncs = pkkt._pcg.steps, pkkt._pcg.syncs
    sol = pt.solve_proxqp(p, _pst(SMOOTH_SETTINGS))
    counts = (pkkt._pcg.steps - steps, pkkt._pcg.syncs - syncs)
    return args, jprox.solve_jit(j, SMOOTH_SETTINGS), sol, counts


def test_sparse_prox_solve_matches_jax(smooth):
    """tests/test_proxqp.py:283-313: the sparse solve (CG steps counted,
    one sync a step) against JAX's sparse solve, and against the port's own
    dense path (1e-8, as there)."""
    args, ref, sol, (steps, syncs) = smooth
    assert steps > 0 and syncs >= steps
    _same(sol, ref)
    assert int(sol.info.status) == 3
    dense = [a.toarray() if sp.issparse(a) else a for a in args]
    sol_d = pt.solve_proxqp(pt.make_proxqp(*dense, device="cpu"),
                            _pst(SMOOTH_SETTINGS))
    assert (sol.x - sol_d.x.reshape(-1)).abs().max() <= 1e-8
    assert float((args[4] @ sol.x.numpy()).max()) <= 1e-6


@pytest.mark.parametrize("storage", ["ell", "bcoo"])
def test_sparse_prox_storage_matches_jax(storage, smooth):
    """tests/test_proxqp.py:488-513: CSR ("bcoo") storage reproduces the
    ELL solve (1e-8, as there); both match JAX's ELL solve."""
    args, ref, sol_e, _ = smooth
    if storage == "bcoo":
        p = pt.make_sparse_proxqp(*args, dtype=np.float64, storage=storage,
                                  device="cpu")
        sol = pt.solve_proxqp(p, _pst(SMOOTH_SETTINGS))
        assert (sol.x - sol_e.x).abs().max() <= 1e-8
    else:
        sol = sol_e
    _same(sol, ref)


def test_sparse_prox_box_form_parity():
    """tests/test_proxqp.py:316-345: the sparse prox solve against JAX's,
    and against the port's box-form ADMM solve of the same QP (1e-6, as
    there)."""
    args = _split_problem()
    j, p = _pair(args)
    st = qps.ProxQPSettings(max_iterations=4000, eps_abs=1e-9, eps_rel=1e-9,
                            cg_eps=1e-12, cg_max_iterations=500,
                            kkt_warm_start=False)
    sol = pt.solve_proxqp(p, _pst(st))
    _same(sol, jprox.solve_jit(j, st))
    dense = [a.toarray() if sp.issparse(a) else a for a in args]
    box = pt.make_proxqp(*dense, device="cpu").to_box_qp()
    ref = pt.solve(box, pt.Settings(max_iterations=50_000, eps_abs=1e-9,
                                    eps_rel=1e-9, rho=0.1))
    assert int(ref.info.status) >= 2
    assert (sol.x - ref.x.reshape(-1)).abs().max() <= 1e-6


def test_sparse_prox_anderson_matches_jax():
    """tests/test_proxqp.py:407-431: Anderson on the sparse path."""
    rng = np.random.default_rng(0)
    n, me, mi = 60, 6, 12
    P = sp.identity(n, format="csr") * 2.0
    q = rng.standard_normal(n)
    A = sp.random(me, n, density=0.2, format="csr",
                  data_rvs=rng.standard_normal)
    C = sp.random(mi, n, density=0.2, format="csr",
                  data_rvs=rng.standard_normal)
    x_feas = rng.standard_normal(n)
    args = (P, q, A, A @ x_feas, C, C @ x_feas + rng.random(mi))
    j, p = _pair(args)
    st = qps.ProxQPSettings(max_iterations=4000, eps_abs=1e-9, eps_rel=1e-9,
                            anderson_memory=8, kkt_warm_start=False)
    sol = pt.solve_proxqp(p, _pst(st))
    _same(sol, jprox.solve_jit(j, st))
    assert int(sol.info.status) == 3


def test_sparse_prox_default_warm_start_and_history_match_jax():
    """The default start on a SparseProxQP is warm_start_operator; with
    record_history the trace matches JAX's (1e-8) and adaptive rho moves."""
    args = _split_problem(seed=4)
    j, p = _pair(args)
    st = qps.ProxQPSettings(max_iterations=1500, eps_abs=1e-8, eps_rel=1e-8,
                            cg_eps=1e-12, cg_max_iterations=500,
                            record_history=True, check_interval=25)
    sol = pt.solve_proxqp(p, _pst(st))
    ref = jprox.solve_jit(j, st)
    _same(sol, ref)
    for k in ("res_prim", "res_dual", "rho"):
        a, b = sol.info.history[k].numpy(), np.asarray(ref.info.history[k])
        fin = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), fin), k
        assert np.abs(a[fin] - b[fin]).max() <= 1e-8 * max(1.0, np.abs(b[fin]).max()), k
    assert float(sol.info.rho) != st.rho


def test_sparse_prox_segmented_matches_monolithic():
    """tests/test_proxqp.py:516-531 on the sparse path: segment boundaries
    are check boundaries (x within 1e-9 of the monolithic solve), and the
    segmented solve matches JAX's segmented solve."""
    args = _split_problem(n=40, me=4, mi=12, seed=5)
    j, p = _pair(args)
    st = qps.ProxQPSettings(max_iterations=600, eps_abs=1e-9, eps_rel=1e-8,
                            check_interval=25, kkt_warm_start=False,
                            cg_eps=1e-12, cg_max_iterations=500)
    sol_m = pt.solve_proxqp(p, _pst(st))
    sol_s = pprox.solve_segmented(p, _pst(st), segment_iterations=100)
    assert int(sol_m.info.status) == int(sol_s.info.status) == 3
    assert (sol_m.x - sol_s.x).abs().max() <= 1e-9
    assert abs(int(sol_m.info.iterations) - int(sol_s.info.iterations)) <= 50
    _same(sol_s, jprox.solve_segmented(j, st, segment_iterations=100))


def test_prepared_sparse_prox_matches_jax():
    """prepare() on a SparseProxQP keeps M's Jacobi diagonal; a prepared
    solve with q, b and d changed matches JAX's."""
    args = _split_problem(seed=6)
    j, p = _pair(args)
    st = qps.ProxQPSettings(max_iterations=3000, eps_abs=1e-9, eps_rel=1e-9,
                            cg_eps=1e-12, cg_max_iterations=500,
                            kkt_warm_start=False)
    prep_j = jprox.prepare(j, st)
    prep = pprox.prepare(p, _pst(st))
    assert np.abs(prep.cache.numpy() - np.asarray(prep_j.cache)).max() <= 1e-15
    assert pt.plan_proxqp(p, _pst(st), prepared=True).factor == "prepared"
    rng = np.random.default_rng(9)
    q2 = args[1] + 0.1 * rng.standard_normal(p.n)
    d2 = args[5] + 0.5
    args2 = (args[0], q2, args[2], args[3], args[4], d2)
    j2, p2 = _pair(args2)
    sol = pt.solve_proxqp(p2, _pst(st), prepared=prep)
    _same(sol, jprox.solve_jit(j2, st, prepared=prep_j))


def test_sparse_prox_rejects_sigma_free_and_other_objects():
    j, p = _pair(_split_problem(n=20, me=3, mi=5))
    st = qps.ProxQPSettings(sigma_free_rhs=True, kkt_refinement_steps=0)
    with pytest.raises(ValueError, match="sigma_free_rhs needs a dense"):
        jprox.solve_jit(j, st)
    with pytest.raises(ValueError, match="sigma_free_rhs needs a dense"):
        pt.solve_proxqp(p, _pst(st))
    with pytest.raises(ValueError, match="sigma_free_rhs needs a dense"):
        pprox.prepare(p, _pst(st))
    with pytest.raises(TypeError, match="SparseProxQP"):
        pt.solve_proxqp(object(), pt.ProxQPSettings())


@pytest.mark.parametrize("knobs", [{}, {"fused_chunk": True},
                                   {"fused_chunk": True, "chunk_lanes": 2}],
                         ids=["none", "fused_chunk", "lanes"])
def test_plan_proxqp_operator_branch_matches_jax(knobs):
    j, p = _pair(_split_problem(n=20, me=3, mi=5), dtype=np.float32)
    jp = jplan.plan_proxqp(j, qps.ProxQPSettings(**knobs))
    pp = pt.plan_proxqp(p, pt.ProxQPSettings(**knobs))
    assert (pp.backend, pp.factor, pp.cache, pp.padded, pp.lanes,
            pp.dot_precision) == (jp.backend, jp.factor, jp.cache, jp.padded,
                                  jp.lanes, jp.dot_precision) == (
        "prox_alm", "jacobi_diag", "diag", None, 1, "highest")
    assert (jp.chunk, pp.chunk) == ("xla", "torch")
    assert bool(pp.fallback_reasons) == bool(jp.fallback_reasons)
    assert pp.fallback_reasons[:1] == jp.fallback_reasons[:1]
    if pp.fallback_reasons:
        with pytest.raises(ValueError, match="require_fused"):
            pt.solve_proxqp(p, pt.ProxQPSettings(require_fused=True, **knobs))


# ------------------------------------------------------- the application

def test_operator_builders_identical():
    """problems/operators.py is the JAX package's numpy and scipy code: the
    same arrays bit for bit, and the same CSR structure."""
    rng = np.random.default_rng(1)
    n = 200
    y = np.cumsum(rng.standard_normal(n))
    ref_idx = np.array([0, 40, 95, 150, 199])
    for o in range(1, 7):
        assert np.array_equal(pops.difference_operator(o, n),
                              jops.difference_operator(o, n))
        a = pops.difference_operator_sparse(o, n)
        b = jops.difference_operator_sparse(o, n)
        for f in ("data", "indices", "indptr"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (o, f)
    assert np.array_equal(pops.monotonicity_operator(ref_idx, y),
                          jops.monotonicity_operator(ref_idx, y))
    a = pops.monotonicity_operator_sparse(ref_idx, y)
    b = jops.monotonicity_operator_sparse(ref_idx, y)
    assert (a != b).nnz == 0 and a.shape == b.shape
    for u, v in zip(pops.monotone_smoothing_qp(y, ref_idx, 2, 5.0),
                    jops.monotone_smoothing_qp(y, ref_idx, 2, 5.0)):
        assert np.array_equal(u, v)
    for u, v in zip(pops.monotone_smoothing_sparse_qp(y, ref_idx, 2, 5.0),
                    jops.monotone_smoothing_sparse_qp(y, ref_idx, 2, 5.0)):
        if sp.issparse(u):
            assert (u != v).nnz == 0 and np.array_equal(u.data, v.data)
        else:
            assert np.array_equal(u, v)


@pytest.mark.parametrize("bad", [
    lambda m: m.difference_operator(7, 10),
    lambda m: m.difference_operator(4, 4),
    lambda m: m.difference_operator_sparse(7, 10),
    lambda m: m.monotonicity_operator([3], np.zeros(5)),
    lambda m: m.monotonicity_operator([3, 1], np.zeros(5)),
    lambda m: m.monotonicity_operator_sparse([0, 9], np.zeros(5)),
], ids=["order", "short", "sparse_order", "one_index", "unsorted", "beyond"])
def test_operator_builders_reject_as_jax(bad):
    with pytest.raises(ValueError) as je:
        bad(jops)
    with pytest.raises(ValueError) as pe:
        bad(pops)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("case", ["full", "singular", "batched"])
def test_spsd_sqrt_matches_jax(case):
    """M'M = A within 1e-10, the numerical rank respected, and M's rows
    those of JAX's up to the eigenvectors' signs (distinct eigenvalues)."""
    rng = np.random.default_rng({"full": 1, "singular": 2, "batched": 3}[case])
    if case == "full":
        W = rng.standard_normal((16, 16))
        A, rank = W @ W.T + 0.1 * np.eye(16), 16
    elif case == "singular":
        W = rng.standard_normal((20, 7))
        A, rank = W @ W.T, 7
    else:
        W = rng.standard_normal((4, 10, 10))
        A, rank = np.einsum("bij,bkj->bik", W, W), 10
    M = spsd_sqrt(torch.tensor(A)).numpy()
    Mj = np.asarray(jax_spsd_sqrt(jnp.asarray(A)))
    assert np.abs(np.einsum("...ji,...jk->...ik", M, M) - A).max() <= 1e-10
    assert ((np.abs(M).max(-1) > 1e-8).sum(-1) == rank).all()
    live = np.abs(Mj).max(-1) > 1e-8
    sign = np.sign((M * Mj).sum(-1, keepdims=True))
    assert np.abs((M * sign - Mj)[live]).max() <= 1e-10


def test_monotone_smoothing_sparse_scale():
    """tests/test_operators.py:107-136 (benchmarks/large_smoothing.py's
    problem at n = 2000) through make_sparse_proxqp + CG + Anderson: the
    port's f64 solve ends SOLVED, exactly piecewise monotone, x[0] pinned,
    and matches JAX's solve (identical status and iterations, 1e-8)."""
    n = 2000
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, n)
    y = np.sin(np.pi * t) + 0.05 * rng.standard_normal(n)
    ref_idx = np.array([0, n // 2, n - 1])
    P, q, C, d = pops.monotone_smoothing_sparse_qp(y, ref_idx,
                                                   smooth_order=2, lam=50.0)
    A = sp.csr_matrix(([1.0], ([0], [0])), shape=(1, n))
    args = (P, q, A, np.array([y[0]]), C, d)
    j, p = _pair(args)
    st = qps.ProxQPSettings(max_iterations=2000, eps_abs=1e-6, eps_rel=1e-6,
                            cg_eps=1e-10, cg_max_iterations=300,
                            anderson_memory=8)
    sol = pt.solve_proxqp(p, _pst(st))
    assert int(sol.info.status) == 3, int(sol.info.status)
    x = sol.x.numpy()
    half = n // 2
    assert (np.diff(x[: half + 1]) >= -1e-6).all()
    assert (np.diff(x[half:]) <= 1e-6).all()
    assert abs(x[0] - y[0]) <= 1e-6
    _same(sol, jprox.solve_jit(j, st))
