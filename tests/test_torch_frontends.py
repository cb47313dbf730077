"""The port's polish, prepared factors, segmented solves and frontends
(reuse, sequence, LSQ) against the JAX package's.

f64 on the CPU. Each solve pair shares its inputs (numpy, from a seed);
unless a test says otherwise the bar is identical statuses and iteration
counts with x and y within 1e-9 (polish, whose accept mask must be
identical) or 1e-7 (whole solves, as tests/test_torch_admm.py).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.frontends import lsq as jlsq
from quadraticprogramsolver_tpu.frontends import sequence as jseq
from quadraticprogramsolver_tpu.models import admm as jadmm
from quadraticprogramsolver_tpu.models import polish as jpolish
from quadraticprogramsolver_tpu.models import proxqp as jprox

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.frontends import lsq as plsq
from quadraticprogramsolver_tpu_torch.frontends import sequence as pseq
from quadraticprogramsolver_tpu_torch.models import admm as padmm
from quadraticprogramsolver_tpu_torch.models import kkt as pkkt
from quadraticprogramsolver_tpu_torch.models import polish as ppolish
from quadraticprogramsolver_tpu_torch.models import proxqp as pprox
from quadraticprogramsolver_tpu_torch.utils.interop import (
    prox_settings_from_dict, settings_from_dict)

SET = qps.Settings(max_iterations=2000, eps_abs=1e-6, eps_rel=1e-6, rho=0.1,
                   adaptive_rho=False)
SOLVE_TOL = 1e-7


def _np(qp):
    return tuple(np.asarray(v) for v in (qp.P, qp.q, qp.A, qp.l, qp.u))


def _fleet(batch=4, n=40, m=20, seed=0, cls=qps.ProblemClass.RANDOM_QP):
    qp_j = qps.generate_batch(cls, batch=batch, num_elements=n,
                              num_constraints=m, seed=seed, dtype=np.float64)
    return qp_j, pt.make_qp(*_np(qp_j), device="cpu")


def _pst(st):
    return settings_from_dict(dataclasses.asdict(st))


def _same(sol, ref, tol=SOLVE_TOL, names=("x", "y", "z")):
    np.testing.assert_array_equal(sol.info.status.numpy(),
                                  np.asarray(ref.info.status))
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    for name in names:
        a, b = getattr(sol, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= tol, (name, np.abs(a - b).max())


# --- polish -----------------------------------------------------------------

@pytest.mark.parametrize("iters", [1, 3])
def test_polish_matches_jax(iters):
    """Both polishes on the same loose-eps ADMM point: the accept mask is
    identical and so are x and y to 1e-9."""
    qp_j, qp = _fleet(batch=6, n=30, m=15, seed=3)
    st = qps.Settings(max_iterations=4000, eps_abs=1e-3, eps_rel=1e-3,
                      rho=0.1, polish_iterations=iters)
    base = qps.solve_jit(qp_j, dataclasses.replace(st, polish_iterations=0))
    x, z, y, rho = (np.array(v) for v in (base.x, base.z, base.y,
                                          base.info.rho))
    xj, yj = jpolish.polish(qp_j, st, *(jnp.asarray(v) for v in (x, z, y, rho)))
    xp, yp = ppolish.polish(qp, _pst(st), *(torch.from_numpy(v)
                                            for v in (x, z, y, rho)))
    acc_j = (np.asarray(xj) != x).any(-1)
    acc_p = (xp.numpy() != x).any(-1)
    np.testing.assert_array_equal(acc_p, acc_j)
    assert acc_p.any()
    assert np.abs(xp.numpy() - np.asarray(xj)).max() <= 1e-9
    assert np.abs(yp.numpy() - np.asarray(yj)).max() <= 1e-9
    err = [ppolish._kkt_error(qp, torch.from_numpy(a), torch.from_numpy(b))
           for a, b in ((x, y), (xp.numpy(), yp.numpy()))]
    assert (err[1] <= err[0]).all() and (err[1][acc_p] < err[0][acc_p]).all()


def test_polished_solve_matches_jax():
    qp_j, qp = _fleet(batch=4, n=30, m=15, seed=5)
    st = qps.Settings(max_iterations=4000, eps_abs=1e-4, eps_rel=1e-4,
                      rho=0.1, polish_iterations=3)
    ref = qps.solve_jit(qp_j, st)
    sol = pt.solve(qp, _pst(st))
    _same(sol, ref, tol=1e-9)
    np.testing.assert_allclose(sol.info.objective.numpy(),
                               np.asarray(ref.info.objective), rtol=1e-12)


def test_polish_refuses_m_greater_than_n():
    """m > n no longer refuses: as in the JAX package the polish takes the
    matrix-free MINRES route (polish_minres), and the whole solve matches
    JAX's (identical statuses and iterations, x and y within 1e-9, the
    accept mask identical)."""
    qp_j, qp = _fleet(batch=2, n=10, m=30, seed=0,
                      cls=qps.ProblemClass.INEQUALITY_QP)
    assert qp.m > qp.n
    st = qps.Settings(max_iterations=2000, eps_abs=1e-5, eps_rel=1e-5,
                      rho=0.1, polish_iterations=3)
    ref = qps.solve_jit(qp_j, st)
    steps = pkkt._minres.steps
    sol = pt.solve(qp, _pst(st))
    assert pkkt._minres.steps > steps
    _same(sol, ref, tol=1e-9)
    plain = pt.solve(qp, _pst(dataclasses.replace(st, polish_iterations=0)))
    moved = (sol.x != plain.x).any(-1).numpy()
    moved_j = (np.asarray(ref.x) != np.asarray(plain.x)).any(-1)
    np.testing.assert_array_equal(moved, moved_j)


# --- prepared factors ---------------------------------------------------------

@pytest.mark.parametrize("sigma_free", [False, True], ids=["minv", "sigma_free"])
def test_prepared_solves_match_jax(sigma_free):
    """prepare once, then solve with q, l and u changed each time."""
    qp_j, qp = _fleet(seed=2)
    st = dataclasses.replace(SET, sigma_free_rhs=sigma_free,
                             kkt_refinement_steps=0 if sigma_free else 1)
    prep_j = jadmm.prepare(qp_j, st)
    prep_p = pt.prepare(qp, _pst(st))
    assert (prep_p.M_inv is not None) == sigma_free
    if sigma_free:
        assert prep_p.cache["G"].is_contiguous()
    p = pt.plan(qp, _pst(st), prepared=True)
    assert (p.factor, p.cache, p.padded) == (
        "prepared", "G_g" if sigma_free else "M_inv", None)
    rng = np.random.default_rng(0)
    q, l, u = _np(qp_j)[1], _np(qp_j)[3], _np(qp_j)[4]
    for k in range(3):
        q = q + 0.1 * rng.standard_normal(q.shape)
        l, u = l - 0.05 * k, u + 0.05 * k
        ref = qps.solve_jit(dataclasses.replace(
            qp_j, q=jnp.asarray(q), l=jnp.asarray(l), u=jnp.asarray(u)), st,
            prepared=prep_j)
        sol = pt.solve(dataclasses.replace(
            qp, q=torch.from_numpy(q), l=torch.from_numpy(l),
            u=torch.from_numpy(u)), _pst(st), prepared=prep_p)
        _same(sol, ref)
        assert (sol.info.status.numpy() >= 2).all()


def test_prepare_refusals_match_jax():
    qp_j, qp = _fleet(batch=4, n=128, m=128)
    for kw in (dict(scaling_iters=5),
               dict(sigma_free_rhs=True, fused_factor=True, fused_chunk=True,
                    kkt_refinement_steps=0, adaptive_rho=False,
                    slab_cache=True)):
        st = qps.Settings(**kw)
        with pytest.raises(ValueError) as ej:
            jadmm.prepare(qp_j, st)
        with pytest.raises(ValueError, match=re.escape(str(ej.value))):
            pt.prepare(qp, _pst(st))
    prep = pt.prepare(qp, pt.Settings())
    with pytest.raises(ValueError, match="scaling"):
        pt.solve(qp, pt.Settings(scaling_iters=3), prepared=prep)


def test_prepared_fused_chunk_is_not_padded():
    _, qp = _fleet(batch=4, n=100, m=50)
    st = pt.Settings(fused_chunk=True, sigma_free_rhs=True,
                     kkt_refinement_steps=0)
    p = pt.plan(qp, st, prepared=True)
    assert (p.padded, p.chunk) == (None, "torch")
    assert any("not padded" in r for r in p.fallback_reasons)


# --- segmented solves -----------------------------------------------------------

@pytest.mark.parametrize("host_rho", [False, True], ids=["device_rho", "host_rho"])
@pytest.mark.parametrize("mem", [0, 8], ids=["plain", "anderson"])
def test_segmented_solve_matches_jax(host_rho, mem):
    """Anderson's history carried across segments, the segments' traces
    stitched into one."""
    qp_j, qp = _fleet(batch=4, n=20, m=40, seed=0,
                      cls=qps.ProblemClass.INEQUALITY_QP)
    st = qps.Settings(max_iterations=3000, eps_abs=1e-7, eps_rel=1e-7,
                      rho=0.1, anderson_memory=mem, record_history=True)
    ref = jadmm.solve_segmented(qp_j, st, segment_iterations=200,
                                host_rho_adaptation=host_rho)
    sol = padmm.solve_segmented(qp, _pst(st), segment_iterations=200,
                                host_rho_adaptation=host_rho)
    _same(sol, ref)
    for k in ("res_prim", "rho"):
        a = np.asarray(ref.info.history[k])
        b = sol.info.history[k].numpy()
        assert a.shape == b.shape == (st.num_checks, 4)
        assert np.array_equal(np.isinf(a), np.isinf(b))
        fin = np.isfinite(a)
        np.testing.assert_allclose(b[fin], a[fin], rtol=1e-6, atol=1e-9)


def test_prox_segmented_history_matches_jax():
    rng = np.random.default_rng(4)
    B, n, me, mi = 3, 12, 3, 6
    M = rng.standard_normal((B, n, n))
    P = M @ M.transpose(0, 2, 1) / n + np.eye(n)
    A, C = rng.standard_normal((B, me, n)), rng.standard_normal((B, mi, n))
    x0 = rng.standard_normal((B, n))
    arrs = (P, rng.standard_normal((B, n)), A, np.einsum("bij,bj->bi", A, x0),
            C, np.einsum("bij,bj->bi", C, x0) + rng.random((B, mi)))
    pj = qps.ProxQPProblem(*(jnp.asarray(v) for v in arrs))
    pp = pt.make_proxqp(*arrs, device="cpu")
    st = qps.ProxQPSettings(max_iterations=2000, eps_abs=1e-8, eps_rel=1e-8,
                            record_history=True, anderson_memory=4)
    ref = jprox.solve_segmented(pj, st, 150)
    sol = pprox.solve_segmented(pp, prox_settings_from_dict(
        dataclasses.asdict(st)), 150)
    _same(sol, ref, names=("x", "y", "s", "z"))
    a, b = np.asarray(ref.info.history["res_prim"]), sol.info.history["res_prim"].numpy()
    assert a.shape == b.shape == (st.num_checks, B)
    assert np.array_equal(np.isinf(a), np.isinf(b))
    assert np.isinf(b[-1]).all() and np.isfinite(b[0]).all()


# --- reuse: CachedQPSolver -------------------------------------------------------

def test_cached_solver_matches_jax():
    qp_j, qp = _fleet(seed=11)
    sj = qps.CachedQPSolver(qp_j, SET)
    sp = pt.CachedQPSolver(qp, _pst(SET))
    assert sp.prepared.rho.shape == (4,) and sp.qp is not None
    _same(sp.solve(), sj.solve())
    rng = np.random.default_rng(1)
    q2 = _np(qp_j)[1] * 0.5 + 0.2
    l2 = _np(qp_j)[3] - 0.3
    sj.update(q=q2, l=l2)
    sp.update(q=q2, l=l2)
    assert sp.qp.q.device.type == "cpu" and sp.qp.q.dtype == torch.float64
    _same(sp.solve(warm_start=True), sj.solve(warm_start=True))
    P2 = _np(qp_j)[0] + 0.05 * np.eye(qp.n)
    A2 = _np(qp_j)[2] * (1.0 + 0.1 * rng.random())
    sj.refactor(P=P2, A=A2)
    sp.refactor(P=P2, A=A2)
    _same(sp.solve(warm_start=True), sj.solve(warm_start=True))
    with pytest.raises(ValueError, match="shape"):
        sp.update(q=np.zeros((4, 13)))
    with pytest.raises(ValueError, match="shape"):
        sp.refactor(P=np.eye(3))
    # mesh= runs since the distributed modes were ported (held to JAX's
    # mesh solver on a 4-rank world in tests/test_torch_parallel_dense.py);
    # an object that is no mesh fails in both packages alike.
    for pkg, q in ((qps, qp_j), (pt, qp)):
        with pytest.raises(AttributeError, match="shape"):
            pkg.CachedQPSolver(q, SET if pkg is qps else _pst(SET),
                               mesh=object())
    with pytest.raises(ValueError, match="scaling_iters"):
        pt.CachedQPSolver(qp, pt.Settings(scaling_iters=2))


# --- sequences --------------------------------------------------------------------

def _seq(T=4, B=3, n=24, m=12, seed=9):
    qp_j, qp = _fleet(batch=B, n=n, m=m, seed=seed)
    drift = np.linspace(0.0, 1.0, T)[:, None, None]
    q_seq = _np(qp_j)[1][None] * (1.0 + 0.25 * drift)
    return qp_j, qp, q_seq


@pytest.mark.parametrize("static", [False, True], ids=["per_tick", "static"])
@pytest.mark.parametrize("carry_rho", [True, False], ids=["rho", "no_rho"])
def test_solve_sequence_matches_jax(static, carry_rho):
    T = 4
    qp_j, qp, q_seq = _seq(T)
    st = dataclasses.replace(SET, adaptive_rho=True)
    tile = [np.broadcast_to(v, (T,) + v.shape).copy() for v in _np(qp_j)]
    tile[1] = q_seq
    seq_j = qps.QP(*(jnp.asarray(v) for v in tile))
    seq_p = pt.QP(*(torch.from_numpy(v) for v in tile))
    ref = jseq.solve_sequence_jit(seq_j, st, None, carry_rho, static)
    sol = pseq.solve_sequence(seq_p, _pst(st), None, carry_rho, static)
    assert sol.x.shape == (T, 3, 24) and sol.info.rho.shape == (T, 3)
    _same(sol, ref)
    x, z, y = pseq.warm_start_from(pt.solve(pt.QP(*(t[-1] for t in seq_p.tensors())),
                                            _pst(st)))
    assert x.shape == (3, 24) and z.shape == y.shape == (3, 12)


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "per_tick"])
def test_solve_sequence_vectors_unbatched_matrices_match_jax(reuse):
    """P and A stored once, without the batch axes (examples/mpc_fleet.py's
    form): the batch comes from q, and both packages broadcast them."""
    T, B, n = 3, 4, 16
    rng = np.random.default_rng(2)
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + 0.01 * np.eye(n)
    q0 = rng.standard_normal((B, n))
    q_seq = q0[None] + np.cumsum(0.02 * rng.standard_normal((T, B, n)), axis=0)
    arrs = (P, q0, np.eye(n), np.full((B, n), -0.5), np.full((B, n), 0.5))
    qp_j = qps.QP(*(jnp.asarray(v) for v in arrs))
    qp = pt.QP(*(torch.from_numpy(v) for v in arrs))
    assert qp.P.dim() == 2 and qp.batch_shape == (B,)
    st = qps.Settings(max_iterations=1000, eps_abs=1e-6, eps_rel=1e-6,
                      rho=0.4, adaptive_rho=False, check_interval=12)
    ref = jseq.solve_sequence_vectors_jit(qp_j, jnp.asarray(q_seq), None, None,
                                          st, None, reuse)
    sol = pseq.solve_sequence_vectors(qp, torch.from_numpy(q_seq), None, None,
                                      _pst(st), None, reuse)
    assert sol.x.shape == (T, B, n)
    _same(sol, ref)
    assert (sol.info.status.numpy() >= 2).all()
    # One solve of the unbatched form: the same as with P and A tiled, also
    # at a shape where the fused chunk's kernels read P and A by lane.
    M = torch.from_numpy(rng.standard_normal((128, 128)))
    big = pt.QP(M @ M.T / 128 + 0.01 * torch.eye(128, dtype=torch.float64),
                torch.from_numpy(rng.standard_normal((B, 128))),
                torch.eye(128, dtype=torch.float64),
                torch.full((B, 128), -0.5, dtype=torch.float64),
                torch.full((B, 128), 0.5, dtype=torch.float64))
    for one, fused in ((qp, False), (big, True)):
        stp = dataclasses.replace(_pst(st), fused_chunk=fused)
        assert pt.plan(one, stp).chunk == ("fused_kernel" if fused else "torch")
        tiled = pt.QP(one.P.expand(B, one.n, one.n), one.q,
                      one.A.expand(B, one.m, one.n), one.l, one.u)
        a, b = pt.solve(one, stp), pt.solve(tiled, stp)
        assert torch.equal(a.info.iterations, b.info.iterations)
        assert (a.x - b.x).abs().max() <= 1e-12


def test_solve_sequence_vectors_bounds_match_jax():
    T = 3
    qp_j, qp, q_seq = _seq(T, seed=4)
    widen = np.asarray([0.0, 0.1, 0.2])[:, None, None]
    l_seq = _np(qp_j)[3][None] - widen
    u_seq = _np(qp_j)[4][None] + widen
    ref = jseq.solve_sequence_vectors_jit(
        qp_j, jnp.asarray(q_seq), jnp.asarray(l_seq), jnp.asarray(u_seq), SET)
    sol = pseq.solve_sequence_vectors(
        qp, torch.from_numpy(q_seq), torch.from_numpy(l_seq),
        torch.from_numpy(u_seq), _pst(SET))
    _same(sol, ref)


# --- LSQ ----------------------------------------------------------------------------

def _lsq_data(seed=0, B=3, k=30, n=10):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, k, n))
    b = rng.standard_normal((B, k))
    Bm = rng.standard_normal((B, 4, n))
    c = rng.random((B, 4))
    D = rng.standard_normal((B, 2, n))
    e = 0.1 * rng.standard_normal((B, 2))
    return A, b, Bm, c, D, e


def test_lsq_lowering_matches_jax():
    data = _lsq_data()
    for lower_j, lower_p in ((jlsq.lsq_to_qp, plsq.lsq_to_qp),
                             (jlsq.lsq_to_proxqp, plsq.lsq_to_proxqp)):
        a = lower_j(*data)
        b = lower_p(*data, device="cpu")
        for f in dataclasses.fields(a):
            u, v = np.asarray(getattr(a, f.name)), getattr(b, f.name).numpy()
            assert u.shape == v.shape, f.name
            np.testing.assert_allclose(v, u, rtol=1e-13, atol=1e-13)
    # Unconstrained: empty row blocks.
    qp = plsq.lsq_to_qp(*data[:2], device="cpu")
    assert qp.m == 0
    with pytest.raises(ValueError, match="together"):
        plsq.lsq_to_qp(data[0], data[1], B=data[2], device="cpu")


def test_solve_lsq_both_families_match_jax():
    data = _lsq_data(seed=1)
    st = qps.Settings(max_iterations=5000, eps_abs=1e-8, eps_rel=1e-8, rho=0.1)
    _same(plsq.solve_lsq(*data, settings=_pst(st), device="cpu"),
          jlsq.solve_lsq(*data, settings=st))
    pst = qps.ProxQPSettings(max_iterations=3000, eps_abs=1e-9, eps_rel=1e-9)
    ref = jlsq.solve_lsq_proxqp(*data, settings=pst)
    sol = plsq.solve_lsq_proxqp(*data, settings=prox_settings_from_dict(
        dataclasses.asdict(pst)), device="cpu")
    _same(sol, ref, names=("x", "y", "s", "z"))
    # Tensors keep their device.
    t = [torch.from_numpy(v) for v in data]
    assert plsq.lsq_to_qp(*t).P.device.type == "cpu"


def test_solve_info_properties():
    _, qp = _fleet(batch=3, n=20, m=10)
    sol = pt.solve(qp, _pst(SET))
    assert torch.equal(sol.info.solved, (sol.info.status == 2) | (sol.info.status == 3))
    assert not sol.info.infeasible.any()
    assert jax is not None  # the JAX package's config (tests/conftest.py)
