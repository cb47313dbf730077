"""The port's KKT_LDL and KKT_MINRES backends, its MINRES polish and their
plans against the JAX package.

f64 on the CPU; each pair shares its numpy inputs (from a seed). Tolerances:

- backend pieces: the LDL factor (L, d) within 1e-12 of JAX's, a backend
  solve within 1e-8 of a dense numpy solve at per-row rho (JAX's
  tests/test_kkt.py bar) and within 1e-10 of JAX's backend; ``_minres``
  within 1e-10 of JAX's with the same step count;
- whole solves: identical statuses and iteration counts, x and y within
  1e-8. The MINRES solves run at cg_eps 1e-11: at JAX's default 1e-9 the
  inner solves of the two packages stop a step apart now and then (sums in
  another order), which moves huber's x by 2.4e-8 with the iterations still
  identical; at 1e-11 every class agrees within 1e-10;
- the MINRES polish: the same accept mask, x and y within 1e-8.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.core.settings import KKTBackendKind as JKind
from quadraticprogramsolver_tpu.models import kkt as jkkt
from quadraticprogramsolver_tpu.models import plan as jplan
from quadraticprogramsolver_tpu.models import polish as jpolish
from quadraticprogramsolver_tpu.problems import generator as jgen

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.models import kkt as pkkt
from quadraticprogramsolver_tpu_torch.models import polish as ppolish
from quadraticprogramsolver_tpu_torch.utils.interop import settings_from_dict

KINDS = ("CHOLESKY", "KKT_LDL", "CG", "KKT_MINRES")
# tests/test_admm.py's instances (restated: that module is a JAX test file).
SMALL_M = {"lasso": 30, "huber": 30, "svm": 30, "inequality_qp": 30}
FEASIBLE_SEEDS = {
    "random_qp": (0, 3, 4), "inequality_qp": (0, 1, 2),
    "equality_qp": (6, 7), "optimal_control": (0, 3, 4),
    "portfolio": (0, 1, 2), "lasso": (0, 1, 2), "huber": (0, 1, 2),
    "svm": (0, 1, 2), "isotonic": (0, 1, 2),
}
CLASS_SETTINGS = dict(max_iterations=20_000, eps_abs=1e-6, eps_rel=1e-6,
                      rho=0.1, adaptive_rho=True)
MINRES_CG_EPS = 1e-11
SOLVE_TOL = 1e-8
POLISH_SETTINGS = qps.Settings(polish_iterations=10)


def _np(qp):
    return tuple(np.asarray(v) for v in (qp.P, qp.q, qp.A, qp.l, qp.u))


def _pst(st):
    return settings_from_dict(dataclasses.asdict(st))


def _same(sol, ref, tol=SOLVE_TOL):
    np.testing.assert_array_equal(sol.info.status.numpy(),
                                  np.asarray(ref.info.status))
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    for name in ("x", "y"):
        dev = np.abs(getattr(sol, name).numpy()
                     - np.asarray(getattr(ref, name))).max()
        assert dev <= tol, (name, dev)


# ------------------------------------------------------------ the LDL factor

def _quasi_definite(B=3, n=12, m=6, seed=5, well_conditioned=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, n, n))
    if well_conditioned:
        # MINRES in floating point amplifies a rounding difference by the
        # system's condition number a step: here the two packages stay
        # within 1e-10 at every step.
        H = X @ X.transpose(0, 2, 1) / n + np.eye(n)
    else:
        H = X @ X.transpose(0, 2, 1) + 0.1 * np.eye(n)
    A = rng.standard_normal((B, m, n))
    D = np.stack([np.diag(1.0 / r) for r in rng.uniform(0.2, 3.0, (B, m))])
    K = np.concatenate([np.concatenate([H, A.transpose(0, 2, 1)], -1),
                        np.concatenate([A, -D], -1)], -2)
    return H, A, D, K


def test_ldl_factor_matches_jax():
    """L and d within 1e-12 of JAX's masked-scan factor; L D L' = K."""
    _, _, _, K = _quasi_definite()
    Lj, dj = (np.asarray(v) for v in jkkt._ldl_factor(jnp.asarray(K)))
    L, d = (v.numpy() for v in pkkt._ldl_factor(torch.tensor(K)))
    assert np.abs(L - Lj).max() <= 1e-12 and np.abs(d - dj).max() <= 1e-12
    assert np.array_equal(L, np.tril(L)) and (np.diagonal(L, 0, 1, 2) == 1).all()
    rebuilt = np.einsum("bij,bj,bkj->bik", L, d, L)
    assert np.abs(rebuilt - K).max() <= 1e-9
    n = 12
    assert (d[:, :n] > 0).all() and (d[:, n:] < 0).all()


def test_build_kkt_matrix_matches_jax():
    qp_j, qp = _fleet()
    rho_row = np.array([[0.3], [1.7]]) * np.ones((2, qp.m))
    Kj = jkkt._build_kkt_matrix(qp_j, jnp.asarray(rho_row), 1e-6)
    K = pkkt._build_kkt_matrix(qp, torch.tensor(rho_row), 1e-6)
    np.testing.assert_array_equal(K.numpy(), np.asarray(Kj))


# ------------------------------------------------------ one backend solve

def _fleet(batch=2, n=24, m=None, seed=0, cls=qps.ProblemClass.RANDOM_QP):
    qp_j = qps.generate_batch(cls, batch=batch, num_elements=n,
                              num_constraints=m, seed=seed, dtype=np.float64)
    return qp_j, pt.make_qp(*_np(qp_j), device="cpu")


def _with_equalities(qp_j, rows=3):
    """The fleet with its first rows made equalities (l = u), so that
    rho_eq_scale weighs them."""
    P, q, A, l, u = _np(qp_j)
    l = l.copy()
    l[:, :rows] = u[:, :rows]
    return (qps.make_qp(P, q, A, l, u, dtype=np.float64),
            pt.make_qp(P, q, A, l, u, device="cpu"))


@pytest.mark.parametrize("rho_eq_scale", [1.0, 1e3], ids=["scalar", "eq1e3"])
@pytest.mark.parametrize("kind", KINDS)
def test_backend_matches_dense_solve(kind, rho_eq_scale):
    """Each backend's solve against a dense f64 solve of the 2x2 KKT system
    at per-row rho (tests/test_kkt.py:38-60 and :158-172), and against the
    JAX backend on the same input."""
    qp_j, qp = _with_equalities(_fleet()[0])
    st = qps.Settings(kkt_backend=JKind[kind], cg_eps=1e-12,
                      cg_max_iterations=2000, kkt_refinement_steps=1,
                      rho_eq_scale=rho_eq_scale)
    pst = _pst(st)
    rng = np.random.default_rng(1)
    B, n, m = 2, qp.n, qp.m
    x, z, y = (rng.standard_normal((B, k)) for k in (n, m, m))
    rho = np.array([0.37, 1.3])
    sigma = st.sigma_for(jnp.float64)
    jb = jkkt.get_backend(JKind[kind], qp_j)
    cj = jb.init(qp_j, jnp.asarray(rho), jnp.asarray(sigma), st)
    xj, zj, _ = jb.solve(cj, qp_j, *(jnp.asarray(v) for v in (x, z, y)),
                         jnp.asarray(rho), st)
    pb = pkkt.get_backend(pt.KKTBackendKind[kind], qp)
    c = pb.init(qp, torch.tensor(rho), pst.sigma_for(torch.float64), pst)
    xx, zz, _ = pb.solve(c, qp, *(torch.tensor(v) for v in (x, z, y)),
                         torch.tensor(rho), pst)
    P, q, A, l, u = _np(qp_j)
    for b in range(B):
        w = np.where(np.isfinite(l[b]) & (l[b] == u[b]), rho_eq_scale, 1.0)
        r = rho[b] * w
        K = np.block([[P[b] + sigma * np.eye(n), A[b].T],
                      [A[b], -np.diag(1.0 / r)]])
        v = np.linalg.solve(K, np.concatenate([sigma * x[b] - q[b],
                                               z[b] - y[b] / r]))
        assert np.abs(xx[b].numpy() - v[:n]).max() <= 1e-8
        assert np.abs(zz[b].numpy() - (z[b] + (v[n:] - y[b]) / r)).max() <= 1e-8
    assert np.abs(xx.numpy() - np.asarray(xj)).max() <= 1e-10
    assert np.abs(zz.numpy() - np.asarray(zj)).max() <= 1e-10


def test_registry_matches_jax():
    """All four backends are registered, with JAX's cheap_refactor flags, and
    MINRES's refactor is free (its cache comes back as it was)."""
    assert set(pkkt.BACKENDS) == set(pt.KKTBackendKind) - {pt.KKTBackendKind.AUTO}
    for kind in KINDS:
        assert (pkkt.BACKENDS[pt.KKTBackendKind[kind]].cheap_refactor
                == jkkt.BACKENDS[JKind[kind]].cheap_refactor), kind
    _, qp = _fleet()
    st = pt.Settings(kkt_backend=pt.KKTBackendKind.KKT_MINRES)
    cache = pkkt.kkt_minres_init(qp, torch.full((2,), 0.1), 1e-6, st)
    assert pkkt.kkt_minres_refactor(cache, qp, torch.full((2,), 5.0), 1e-6,
                                    st) is cache


def test_minres_shared_P_is_not_copied_per_lane():
    """A P shared by the fleet gives one (n, n) preconditioner inverse (JAX
    broadcasts it), and the solve equals the one with P copied per lane."""
    qp_j, qp = _fleet()
    P = qp.P[0]
    shared = pt.QP(P=P, q=qp.q, A=qp.A, l=qp.l, u=qp.u)
    per_lane = pt.QP(P=P.expand(2, -1, -1).contiguous(), q=qp.q, A=qp.A,
                     l=qp.l, u=qp.u)
    st = pt.Settings(kkt_backend=pt.KKTBackendKind.KKT_MINRES, cg_eps=1e-12)
    rho = torch.tensor([0.2, 2.0])
    rng = np.random.default_rng(3)
    x, z, y = (torch.tensor(rng.standard_normal((2, k)))
               for k in (qp.n, qp.m, qp.m))
    outs = []
    for prob in (shared, per_lane):
        c = pkkt.kkt_minres_init(prob, rho, 1e-6, st)
        outs.append(pkkt.kkt_minres_solve(c, prob, x, z, y, rho, st))
    assert outs[0][2]["P_inv"].shape == (qp.n, qp.n)
    assert outs[1][2]["P_inv"].shape == (2, qp.n, qp.n)
    for a, b in zip(outs[0][:2], outs[1][:2]):
        assert (a - b).abs().max() <= 1e-12


# ------------------------------------------------------------------ MINRES

def _minres_system(B=3, n=30, m=20, seed=7):
    H, A, D, K = _quasi_definite(B, n, m, seed, well_conditioned=True)
    Hinv = np.linalg.inv(H)
    Dinv = np.stack([np.diag(1.0 / np.diag(d)) for d in D])
    rng = np.random.default_rng(seed + 1)
    b = rng.standard_normal((B, n + m))
    x0 = 0.1 * rng.standard_normal((B, n + m))
    Minv = np.zeros_like(K)
    Minv[:, :n, :n], Minv[:, n:, n:] = Hinv, Dinv
    return K, Minv, b, x0


def _jax_minres(K, Minv, b, x0, **kw):
    Kj, Mj = jnp.asarray(K), jnp.asarray(Minv)
    return np.asarray(jkkt._minres(
        lambda v: jnp.einsum("bij,bj->bi", Kj, v),
        lambda v: jnp.einsum("bij,bj->bi", Mj, v),
        jnp.asarray(b), jnp.asarray(x0), **kw))


def _port_minres(K, Minv, b, x0, **kw):
    Kt, Mt = torch.tensor(K), torch.tensor(Minv)
    steps = pkkt._minres.steps
    x = pkkt._minres(lambda v: (Kt @ v[..., None])[..., 0],
                     lambda v: (Mt @ v[..., None])[..., 0],
                     torch.tensor(b), torch.tensor(x0), **kw)
    return x.numpy(), pkkt._minres.steps - steps


@pytest.mark.parametrize("tols", [dict(abs_tol=1e-10), dict(abs_tol=0.0,
                                                             rel_tol=1e-10)],
                         ids=["abs", "rel"])
def test_minres_matches_jax(tols):
    """x within 1e-10 of JAX's and the same step count: JAX capped at the
    port's count gives JAX's full result bit for bit, one step fewer does
    not. (Stopped far from the solution, MINRES's iterate moves by the
    solve's own error under a rounding change: JAX against itself with b
    scaled by 1 + 1e-15 differs by 5e-9 at rel_tol 1e-6 on this system. So
    both tolerances here reach the solution to ~1e-10.)"""
    K, Minv, b, x0 = _minres_system()
    kw = dict(max_iterations=200, **tols)
    xj = _jax_minres(K, Minv, b, x0, **kw)
    x, steps = _port_minres(K, Minv, b, x0, **kw)
    assert np.abs(x - xj).max() <= 1e-10
    assert 0 < steps < 200
    assert np.array_equal(_jax_minres(K, Minv, b, x0, **{**kw, "max_iterations": steps}), xj)
    assert not np.array_equal(
        _jax_minres(K, Minv, b, x0, **{**kw, "max_iterations": steps - 1}), xj)
    # The solution: K x = b to the tolerance's order.
    res = np.abs(np.einsum("bij,bj->bi", K, x) - b).max()
    assert res <= 1e-5


def test_minres_done_lane_keeps_its_iterate():
    """A lane done at the start (x0 solves it: beta1 = 0) keeps x0 bit for
    bit, -0.0 entries included, while the other lanes iterate; a lane that
    finishes early keeps the x it had then through the later steps."""
    K, Minv, b, x0 = _minres_system()
    x0[0] = np.linalg.solve(K[0], b[0])
    b[0] = K[0] @ x0[0]
    x0[0, :3] = -0.0
    b[0] = K[0] @ x0[0]
    x, steps = _port_minres(K, Minv, b, x0, abs_tol=1e-10, max_iterations=200)
    assert steps > 0
    assert np.array_equal(x[0].view(np.int64), x0[0].view(np.int64))
    # Lane 1 stops long before lane 2 (whose b is 1e3 times larger against
    # the same absolute tolerance): from the step it stopped at, its x keeps
    # its bits through every later step. (A step's arithmetic does not
    # depend on the cap, so capping at k gives the iterate after k steps.)
    K2, M2, b2, x2 = _minres_system(B=1, seed=11)
    args = (np.concatenate([K[1:2], K2]), np.concatenate([Minv[1:2], M2]),
            np.concatenate([b[1:2], 1e3 * b2]), np.concatenate([x0[1:2], x2]))
    final, total = _port_minres(*args, abs_tol=1e-4, max_iterations=200)
    bits = [_port_minres(*args, abs_tol=1e-4, max_iterations=k)[0]
            for k in range(1, total)]
    same = [np.array_equal(xk[0].view(np.int64), final[0].view(np.int64))
            for xk in bits]
    stop = same.index(True)
    assert all(same[stop:]) and stop + 2 < total
    assert not np.array_equal(bits[stop][1], final[1])


# --------------------------------------------------------- whole solves

def _class_fleet(cls):
    datas = [jgen.generate_random_qp(qps.ProblemClass(cls), 10,
                                     SMALL_M.get(cls, 0), seed=s)
             for s in FEASIBLE_SEEDS[cls]]
    qp_j = qps.stack_qps([qps.make_qp(*d.dense()) for d in datas], pad=True)
    qp = pt.stack_qps([pt.make_qp(*d.dense(), device="cpu") for d in datas],
                      pad=True)
    return qp_j, qp


@pytest.mark.parametrize("cls", [c.value for c in qps.ALL_CLASSES])
def test_ldl_backend_full_solve(cls):
    qp_j, qp = _class_fleet(cls)
    st = qps.Settings(kkt_backend=JKind.KKT_LDL, **CLASS_SETTINGS)
    ref = qps.solve_jit(qp_j, st)
    sol = pt.solve(qp, _pst(st))
    _same(sol, ref)
    assert ((sol.info.status.numpy() >= 2) & (sol.info.status.numpy() <= 3)).all()


@pytest.mark.parametrize("cls", [c.value for c in qps.ALL_CLASSES])
def test_minres_backend_full_solve(cls):
    qp_j, qp = _class_fleet(cls)
    st = qps.Settings(kkt_backend=JKind.KKT_MINRES, cg_eps=MINRES_CG_EPS,
                      cg_max_iterations=1000, **CLASS_SETTINGS)
    ref = qps.solve_jit(qp_j, st)
    steps = pkkt._minres.steps
    sol = pt.solve(qp, _pst(st))
    assert pkkt._minres.steps > steps
    _same(sol, ref)
    assert ((sol.info.status.numpy() >= 2) & (sol.info.status.numpy() <= 3)).all()


def test_ldl_backend_batched():
    """tests/test_kkt.py:126-136: a B = 4 fleet through LDL, against JAX's
    LDL solve and the port's own CHOLESKY solve (1e-6, as there)."""
    qp_j, qp = _fleet(batch=4, n=16, seed=1)
    kw = dict(max_iterations=20_000, eps_abs=1e-7, eps_rel=1e-7, rho=0.1,
              adaptive_rho=True)
    st = qps.Settings(kkt_backend=JKind.KKT_LDL, **kw)
    sol = pt.solve(qp, _pst(st))
    _same(sol, qps.solve_jit(qp_j, st))
    chol = pt.solve(qp, pt.Settings(**kw))
    assert (sol.x - chol.x).abs().max() <= 1e-6


@pytest.mark.parametrize("storage", ["ell", "bcoo"])
def test_minres_backend_sparse_full_solve(storage):
    """tests/test_kkt.py:174-188: a SparseQP through MINRES (the Jacobi
    preconditioner), ELL or CSR storage, against JAX's ELL solve."""
    data = jgen.generate_random_qp(qps.ProblemClass.RANDOM_QP, 100, seed=2)
    args = (data.P, data.q, data.A, data.l, data.u)
    st = qps.Settings(max_iterations=20_000, eps_abs=1e-7, eps_rel=1e-7,
                      rho=0.1, adaptive_rho=True, cg_eps=1e-10,
                      cg_max_iterations=1000, kkt_backend=JKind.KKT_MINRES)
    ref = qps.solve_jit(qps.make_sparse_qp(*args, dtype=np.float64), st)
    sqp = pt.make_sparse_qp(*args, dtype=np.float64, storage=storage,
                            device="cpu")
    sol = pt.solve(sqp, _pst(st))
    assert int(sol.info.status) == int(ref.info.status) == 3
    assert int(sol.info.iterations) == int(ref.info.iterations)
    for name in ("x", "y"):
        dev = np.abs(getattr(sol, name).numpy()
                     - np.asarray(getattr(ref, name))).max()
        assert dev <= SOLVE_TOL, (name, dev)


@pytest.mark.parametrize("kind", ["KKT_LDL", "KKT_MINRES"])
def test_anderson_with_backend(kind):
    """tests/test_anderson.py:81-94: Anderson over a non-default backend."""
    data = jgen.generate_random_qp(qps.ProblemClass.PORTFOLIO, 40, seed=0)
    qp_j = qps.make_qp(*data.dense(), dtype=np.float64)
    qp = pt.make_qp(*data.dense(), device="cpu")
    st = qps.Settings(max_iterations=50_000, eps_abs=1e-7, eps_rel=1e-7,
                      rho=0.1, anderson_memory=8, kkt_backend=JKind[kind],
                      cg_eps=MINRES_CG_EPS)
    ref = qps.solve_jit(qp_j, st)
    sol = pt.solve(qp, _pst(st))
    np.testing.assert_array_equal(sol.info.status.numpy(),
                                  np.asarray(ref.info.status))
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    assert np.abs(sol.x.numpy() - np.asarray(ref.x)).max() <= SOLVE_TOL


# ------------------------------------------------------------------- plans

@pytest.mark.parametrize("knobs", [{}, {"fused_chunk": True},
                                   {"fused_factor": True}],
                         ids=["none", "fused_chunk", "fused_factor"])
@pytest.mark.parametrize("kind", ["KKT_LDL", "KKT_MINRES"])
def test_plan_matches_jax(kind, knobs):
    """The JAX plan's fields on a dense fleet (the chunk names mapped:
    "xla" is "torch") and, for MINRES, on a SparseQP; LDL on a SparseQP
    raises the same ValueError in both."""
    arrs = [np.zeros(s, np.float32) for s in
            ((4, 128, 128), (4, 128), (4, 128, 128), (4, 128), (4, 128))]
    jst, pst = (mod.Settings(kkt_backend=mod.KKTBackendKind[kind], **knobs)
                for mod in (qps, pt))
    jp = jplan.plan(qps.make_qp(*arrs), jst)
    pp = pt.plan(pt.make_qp(*arrs, device="cpu"), pst)
    assert (pp.backend, pp.factor, pp.cache, pp.padded, pp.lanes,
            pp.dot_precision) == (jp.backend, jp.factor, jp.cache, jp.padded,
                                  jp.lanes, jp.dot_precision)
    assert (jp.chunk, pp.chunk) == ("xla", "torch")
    assert bool(pp.fallback_reasons) == bool(jp.fallback_reasons)
    assert pp.factor == {"KKT_LDL": "ldl_scan", "KKT_MINRES": "minres_precond"}[kind]
    data = jgen.generate_random_qp(qps.ProblemClass.RANDOM_QP, 30, seed=0)
    args = (data.P, data.q, data.A, data.l, data.u)
    jq = qps.make_sparse_qp(*args)
    pq = pt.make_sparse_qp(*args, device="cpu")
    if kind == "KKT_LDL":
        with pytest.raises(ValueError, match="requires a dense QP"):
            jplan.plan(jq, jst)
        with pytest.raises(ValueError, match="requires a dense QP"):
            pt.plan(pq, pst)
        return
    jp, pp = jplan.plan(jq, jst), pt.plan(pq, pst)
    assert (pp.backend, pp.factor, pp.cache, pp.padded) == (
        jp.backend, jp.factor, jp.cache, jp.padded) == (
        "kkt_minres", "minres_precond", "diag", None)


# ------------------------------------------------------------------ polish

@pytest.fixture(scope="module")
def tall():
    """tests/test_polish.py:58-73's tall dense problem (m = 10 n) and JAX's
    loose base solve of it, shared by the polish tests."""
    data = jgen.generate_random_qp(qps.ProblemClass.INEQUALITY_QP, 40, seed=1)
    qp_j = qps.make_qp(*data.dense(), dtype=np.float64)
    base = qps.solve_jit(qp_j, qps.Settings(max_iterations=2000, eps_abs=1e-5,
                                            eps_rel=1e-5, rho=0.1))
    return data, qp_j, base


def _polish_pair(qp_j, qp, base, st, ref=None):
    """The two packages' polish_minres from JAX's base point (``ref``: JAX's
    result, when already computed): the same accept mask, x and y within
    SOLVE_TOL. The port's polish runs through the dispatch (``polish``),
    which must take the MINRES route here. Returns the mask."""
    xj, yj = ref or jpolish.polish_minres(qp_j, st, base.x, base.z, base.y,
                                          base.info.rho)
    x, z, y = (torch.tensor(np.asarray(v)) for v in (base.x, base.z, base.y))
    xp, yp = ppolish.polish(qp, _pst(st), x, z, y,
                            torch.tensor(np.asarray(base.info.rho)))
    xj, yj = np.asarray(xj), np.asarray(yj)
    # The accept mask: a lane's x moved off the base x.
    acc_j = (xj != np.asarray(base.x)).any(-1)
    acc = (xp.numpy() != x.numpy()).any(-1)
    np.testing.assert_array_equal(acc, acc_j)
    assert np.abs(xp.numpy() - xj).max() <= SOLVE_TOL
    assert np.abs(yp.numpy() - yj).max() <= SOLVE_TOL
    return acc


def test_polish_minres_tall_dense_matches_jax(tall):
    data, qp_j, base = tall
    qp = pt.make_qp(*data.dense(), device="cpu")
    assert qp.m > qp.n
    acc = _polish_pair(qp_j, qp, base, POLISH_SETTINGS)
    assert acc.all()


def test_polish_minres_rejects_when_ambiguous():
    """tests/test_polish.py:76-90: from a very loose point the accept guard
    decides, identically in both packages, and never makes the KKT error
    worse."""
    data = jgen.generate_random_qp(qps.ProblemClass.INEQUALITY_QP, 30, seed=3)
    qp_j = qps.make_qp(*data.dense(), dtype=np.float64)
    base = qps.solve_jit(qp_j, qps.Settings(max_iterations=100, eps_abs=1e-2,
                                            eps_rel=1e-2, rho=0.1))
    qp = pt.make_qp(*data.dense(), device="cpu")
    _polish_pair(qp_j, qp, base, POLISH_SETTINGS)
    x, z, y = (torch.tensor(np.asarray(v)) for v in (base.x, base.z, base.y))
    xp, yp = ppolish.polish_minres(qp, pt.Settings(polish_iterations=3), x,
                                   z, y, None)
    assert float(ppolish._kkt_error(qp, xp, yp)) <= float(
        ppolish._kkt_error(qp, x, y)) + 1e-12


@pytest.fixture(scope="module")
def sparse_base():
    """tests/test_polish.py:41-55's SparseQP, JAX's loose CG solve of it and
    JAX's polish from there, shared by both storages."""
    data = jgen.generate_random_qp(qps.ProblemClass.RANDOM_QP, 200, seed=2)
    args = (data.P, data.q, data.A, data.l, data.u)
    qp_j = qps.make_sparse_qp(*args, dtype=np.float64)
    base = qps.solve_jit(qp_j, qps.Settings(
        max_iterations=500, eps_abs=1e-4, eps_rel=1e-4, rho=0.1,
        cg_eps=1e-10, cg_max_iterations=500))
    ref = jpolish.polish_minres(qp_j, POLISH_SETTINGS, base.x, base.z,
                                base.y, base.info.rho)
    return args, qp_j, base, ref


@pytest.mark.parametrize("storage", ["ell", "bcoo"])
def test_polish_minres_sparse_matches_jax(storage, sparse_base):
    """Polish on a SparseQP (the dispatch takes MINRES), ELL or CSR, from
    JAX's loose CG solve: JAX's polish_minres within SOLVE_TOL."""
    args, qp_j, base, ref = sparse_base
    qp = pt.make_sparse_qp(*args, dtype=np.float64, storage=storage,
                           device="cpu")
    assert bool(_polish_pair(qp_j, qp, base, POLISH_SETTINGS, ref))


def test_polish_minres_counts_its_krylov_steps(tall):
    """Each sweep is one _minres call; the steps are counted, and a sweep
    never takes more than polish_max_krylov."""
    data, _, base = tall
    qp = pt.make_qp(*data.dense(), device="cpu")
    x, z, y = (torch.tensor(np.asarray(v)) for v in (base.x, base.z, base.y))
    steps, syncs = pkkt._minres.steps, pkkt._minres.syncs
    ppolish.polish_minres(qp, pt.Settings(polish_iterations=3,
                                          polish_max_krylov=7), x, z, y, None)
    assert 0 < pkkt._minres.steps - steps <= 3 * 7
    assert pkkt._minres.syncs - syncs >= pkkt._minres.steps - steps


def test_minres_solve_syncs_once_a_step():
    """The host loop reads the lanes' flags once a step (plus the read that
    ends it), as _pcg does."""
    K, Minv, b, x0 = _minres_system()
    syncs = pkkt._minres.syncs
    _, steps = _port_minres(K, Minv, b, x0, abs_tol=1e-10, max_iterations=200)
    assert pkkt._minres.syncs - syncs == steps + 1
    syncs = pkkt._minres.syncs
    _, steps = _port_minres(K, Minv, b, x0, abs_tol=1e-10, max_iterations=4)
    assert steps == 4 and pkkt._minres.syncs - syncs == 4
