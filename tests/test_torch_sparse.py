"""The port's large sparse path against the JAX package, on the CPU.

The generator, the ELL packing and Ruiz scaling (identical results), the
SparseQP operators in ELL and CSR storage (1e-12 in f64), the CG backend
(``_pcg`` alone, a dense QP on CG) and the sparse ADMM solves (ELL, CSR, and
ELL pre-scaled with ``scaling=``: identical statuses and outer iterations, x
and y within 1e-7 in f64, against ``solve_jit`` on the same instance). Then
the plain versions of the SpMV kernels of rows 13-15: row 13 against JAX's
``_ell_matvec``, the routing packers bit for bit against the probes' own
(``benchmarks/*.py``, numpy only), row 13's previous kernel (its wrapper the
plain version here), the plain matvecs against scipy (f64,
1e-12) and against the probe kernels' bodies, restated in jnp and run
eagerly (the probes' Pallas kernels are closures inside their ``main()``).
The routing kernels' device index (the occupancy masks, the row-routed
block-major order) against the packs, and the plain versions of the fused
row-routed matvec and the masked route levels.
"""

import dataclasses
import pathlib
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.core import sparse_problem as jsp
from quadraticprogramsolver_tpu.core.settings import KKTBackendKind as JKind
from quadraticprogramsolver_tpu.models import kkt as jkkt
from quadraticprogramsolver_tpu.models import plan as jplan
from quadraticprogramsolver_tpu.models.scaling import (
    equilibrate_sparse_host as jax_equilibrate)
from quadraticprogramsolver_tpu.problems import generator as jgen
from quadraticprogramsolver_tpu.utils import oracle as joracle

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.core import sparse_problem as psp
from quadraticprogramsolver_tpu_torch.models import kkt as pkkt
from quadraticprogramsolver_tpu_torch.models.scaling import (
    equilibrate_sparse_host as port_equilibrate)
from quadraticprogramsolver_tpu_torch.ops import routed_spmv as rs
from quadraticprogramsolver_tpu_torch.ops import spmv
from quadraticprogramsolver_tpu_torch.utils import oracle as poracle

BENCH = pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
sys.path.insert(0, str(BENCH))
import routed_spmv_probe  # noqa: E402  (numpy-only at import)
import row_routed_probe  # noqa: E402

N, SEED = 300, 0
#: tests/test_large_sparse.py's settings.
LARGE = dict(max_iterations=2000, eps_abs=1e-6, eps_rel=1e-6, rho=0.1,
             adaptive_rho=True, cg_eps=1e-9, cg_max_iterations=400)
#: tests/test_kkt.py:88-102's settings.
KKT = dict(max_iterations=20_000, eps_abs=1e-7, eps_rel=1e-7, rho=0.1,
           adaptive_rho=True, cg_eps=1e-10, cg_max_iterations=1000)
#: benchmarks/large_sparse.py's inner forcing term.
REL = dict(LARGE, cg_rel_eps=1e-4)
TOL = 1e-7


@pytest.fixture(scope="module")
def data():
    return jgen.generate_large_sparse_qp(N, seed=SEED)


def _args(d):
    return (d.P, d.q, d.A, d.l, d.u)


def _same(port_sol, jax_sol):
    """Identical status and outer iterations, x and y within TOL."""
    assert int(port_sol.info.status) == int(jax_sol.info.status)
    assert int(port_sol.info.iterations) == int(jax_sol.info.iterations)
    for name in ("x", "y", "z"):
        a, b = getattr(port_sol, name).numpy(), np.asarray(getattr(jax_sol, name))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL, (name, np.abs(a - b).max())
    np.testing.assert_allclose(float(port_sol.info.objective),
                               float(jax_sol.info.objective), rtol=1e-9)


# -- generator, packing, scaling --

@pytest.mark.parametrize("n,m,seed", [(N, 0, SEED), (1000, 120, 3)])
def test_generator_matches_jax(n, m, seed):
    a = jgen.generate_large_sparse_qp(n, m, seed=seed)
    b = pt.generate_large_sparse_qp(n, m, seed=seed)
    for name in ("P", "A"):
        ma, mb = getattr(a, name), getattr(b, name)
        assert ma.format == mb.format and ma.shape == mb.shape
        assert (ma != mb).nnz == 0
    for name in ("q", "l", "u"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_array_equal(a.dense()[0], b.dense()[0])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("which", ["P", "A", "At"])
def test_to_ell_is_bit_identical(data, which, dtype):
    M = {"P": data.P, "A": data.A, "At": data.A.T.tocsr()}[which]
    for a, b in zip(jsp._to_ell(M, dtype), psp._to_ell(M, dtype)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_equilibrate_sparse_host_matches_jax(data):
    a = jax_equilibrate(*_args(data), 10)
    b = port_equilibrate(*_args(data), 10, device="cpu")
    for i in (0, 2):  # P_s, A_s
        assert a[i].format == b[i].format and (a[i] != b[i]).nnz == 0
    for i in (1, 3, 4):  # q_s, l_s, u_s
        np.testing.assert_array_equal(a[i], b[i])
    for name in ("d", "e", "c"):
        np.testing.assert_array_equal(np.asarray(getattr(a[5], name)),
                                      getattr(b[5], name).numpy())


# -- operators --

@pytest.mark.parametrize("storage", ["ell", "bcoo"])
def test_sparse_operators_match_jax_and_dense(data, storage):
    jq = qps.make_sparse_qp(*_args(data), dtype=np.float64, storage=storage)
    pq = pt.make_sparse_qp(*_args(data), dtype=np.float64, storage=storage,
                           device="cpu")
    dq = pt.make_qp(*data.dense(), device="cpu")
    assert (pq.n, pq.m, pq.batch_shape, pq.is_dense) == (N, N // 2, (), False)
    assert pq.dtype == torch.float64 and dq.is_dense
    rng = np.random.default_rng(1)
    v, w = rng.standard_normal(N), rng.standard_normal(N // 2)
    wt = rng.uniform(0.5, 2.0, N // 2)
    vt, wtt, wgt = (torch.tensor(a) for a in (v, w, wt))
    pairs = [
        (pq.matvec_P(vt), jq.matvec_P(jnp.asarray(v)), dq.matvec_P(vt)),
        (pq.matvec_A(vt), jq.matvec_A(jnp.asarray(v)), dq.matvec_A(vt)),
        (pq.matvec_At(wtt), jq.matvec_At(jnp.asarray(w)), dq.matvec_At(wtt)),
        (pq.diag_P(), jq.diag_P(), dq.diag_P()),
        (pq.diag_AtA(), jq.diag_AtA(), dq.diag_AtA()),
        (pq.diag_AtWA(wgt), jq.diag_AtWA(jnp.asarray(wt)), dq.diag_AtWA(wgt)),
        (pq.objective(vt), jq.objective(jnp.asarray(v)), dq.objective(vt)),
    ]
    for port, jax_v, dense in pairs:
        assert np.abs(port.numpy() - np.asarray(jax_v)).max() <= 1e-12
        assert np.abs(port.numpy() - dense.numpy()).max() <= 1e-12


def test_dense_operator_protocol_matches_jax():
    d = qps.generate_random_qp(qps.ProblemClass.RANDOM_QP, 20, seed=1)
    jq = qps.make_qp(*d.dense())
    pq = pt.make_qp(*d.dense(), device="cpu")
    w = np.random.default_rng(0).uniform(0.5, 2.0, d.m)
    for a, b in ((pq.diag_P(), jq.diag_P()), (pq.diag_AtA(), jq.diag_AtA()),
                 (pq.diag_AtWA(torch.tensor(w)), jq.diag_AtWA(jnp.asarray(w)))):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-12
    assert pq.is_dense is True


def test_make_sparse_qp_needs_a_device_here(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.make_sparse_qp(*_args(data))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_equilibrate(*_args(data), 2)
    with pytest.raises(ValueError, match="storage"):
        pt.make_sparse_qp(*_args(data), storage="coo", device="cpu")
    q = pt.make_sparse_qp(*_args(data), dtype=torch.float32, device="cpu")
    assert q.device.type == "cpu" and q.P_vals.dtype == torch.float32
    assert q.P_cols.dtype == torch.int32


# -- backend selection and plans --

def test_backend_resolution_matches_jax(data):
    jq = qps.make_sparse_qp(*_args(data), dtype=np.float64)
    pq = pt.make_sparse_qp(*_args(data), dtype=np.float64, device="cpu")
    assert jkkt.resolve_backend(JKind.AUTO, jq) is JKind.CG
    assert pkkt.resolve_backend(pt.KKTBackendKind.AUTO, pq) is pt.KKTBackendKind.CG
    for jk, pk in ((JKind.CHOLESKY, pt.KKTBackendKind.CHOLESKY),
                   (JKind.KKT_LDL, pt.KKTBackendKind.KKT_LDL)):
        with pytest.raises(ValueError) as je:
            jkkt.resolve_backend(jk, jq)
        with pytest.raises(ValueError, match=re.escape(str(je.value))):
            pkkt.resolve_backend(pk, pq)
    # Dense: CHOLESKY up to MAX_DIRECT_KKT_DIM, CG above (shapes only).
    big = dataclasses.make_dataclass("Big", ["n", "m", "is_dense"])
    assert pkkt.resolve_backend(pt.KKTBackendKind.AUTO,
                                big(4000, 1001, True)) is pt.KKTBackendKind.CG
    assert pkkt.resolve_backend(pt.KKTBackendKind.AUTO,
                                big(4000, 1000, True)) is pt.KKTBackendKind.CHOLESKY
    # KKT_MINRES is accepted, and on a sparse problem it resolves to itself
    # in both packages.
    st = pt.Settings(kkt_backend=pt.KKTBackendKind.KKT_MINRES)
    assert pkkt.resolve_backend(st.kkt_backend, pq) is pt.KKTBackendKind.KKT_MINRES
    assert jkkt.resolve_backend(JKind.KKT_MINRES, jq) is JKind.KKT_MINRES


@pytest.mark.parametrize("knobs", [
    {}, {"fused_chunk": True}, {"fused_factor": True},
    {"fused_chunk": True, "chunk_lanes": 2}],
    ids=["none", "fused_chunk", "fused_factor", "lanes"])
def test_plan_and_require_fused_match_jax_on_sparse(data, knobs):
    jq = qps.make_sparse_qp(*_args(data), dtype=np.float32)
    pq = pt.make_sparse_qp(*_args(data), dtype=np.float32, device="cpu")
    jp = jplan.plan(jq, qps.Settings(**knobs))
    pp = pt.plan(pq, pt.Settings(**knobs))
    assert (pp.backend, pp.factor, pp.cache, pp.padded, pp.lanes) == (
        jp.backend, jp.factor, jp.cache, jp.padded, jp.lanes) == (
        "cg", "jacobi_diag", "diag", None, 1)
    assert (jp.chunk, pp.chunk) == ("xla", "torch")
    assert bool(pp.fallback_reasons) == bool(jp.fallback_reasons)
    st = pt.Settings(require_fused=True, **knobs)
    if jp.fallback_reasons:
        with pytest.raises(ValueError, match="require_fused"):
            pt.solve(pq, st)
    with pytest.raises(ValueError, match="sigma_free_rhs"):
        pt.solve(pq, pt.Settings(sigma_free_rhs=True, kkt_refinement_steps=0))


# -- CG --

@pytest.mark.parametrize("rel_tol", [0.0, 1e-4])
def test_pcg_matches_jax(rel_tol):
    rng = np.random.default_rng(7)
    B, n = 3, 40
    G = rng.standard_normal((B, n, n))
    M = G @ G.transpose(0, 2, 1) / n + np.eye(n) * np.array([0.1, 1.0, 3.0])[:, None, None]
    b = rng.standard_normal((B, n))
    x0 = 0.1 * rng.standard_normal((B, n))
    dinv = 1.0 / np.diagonal(M, axis1=1, axis2=2)
    kw = dict(abs_tol=1e-10, max_iterations=60, rel_tol=rel_tol)
    xj = jkkt._pcg(lambda v: jnp.einsum("bij,bj->bi", jnp.asarray(M), v),
                   jnp.asarray(b), jnp.asarray(x0), jnp.asarray(dinv), **kw)
    Mt = torch.tensor(M)
    steps = pkkt._pcg.steps
    xp = pkkt._pcg(lambda v: (Mt @ v[..., None])[..., 0], torch.tensor(b),
                   torch.tensor(x0), torch.tensor(dinv), **kw)
    assert np.abs(xp.numpy() - np.asarray(xj)).max() <= 1e-10
    assert 0 < pkkt._pcg.steps - steps <= 60
    # The cap holds exactly, and a capped solve matches JAX's too.
    kw["max_iterations"] = 3
    xj = jkkt._pcg(lambda v: jnp.einsum("bij,bj->bi", jnp.asarray(M), v),
                   jnp.asarray(b), jnp.asarray(x0), jnp.asarray(dinv), **kw)
    steps = pkkt._pcg.steps
    xp = pkkt._pcg(lambda v: (Mt @ v[..., None])[..., 0], torch.tensor(b),
                   torch.tensor(x0), torch.tensor(dinv), **kw)
    assert pkkt._pcg.steps - steps == 3
    assert np.abs(xp.numpy() - np.asarray(xj)).max() <= 1e-12


def test_dense_qp_on_cg_matches_jax():
    qj = qps.generate_batch(qps.ProblemClass.RANDOM_QP, batch=3,
                            num_elements=40, seed=0, dtype=np.float64)
    kw = dict(max_iterations=4000, eps_abs=1e-6, eps_rel=1e-6, rho=0.1,
              cg_eps=1e-10, cg_max_iterations=500)
    ref = qps.solve_jit(qj, qps.Settings(kkt_backend=JKind.CG, **kw))
    qp = pt.make_qp(*(np.asarray(v) for v in (qj.P, qj.q, qj.A, qj.l, qj.u)),
                    device="cpu")
    st = pt.Settings(kkt_backend=pt.KKTBackendKind.CG, **kw)
    assert pt.plan(qp, st).backend == "cg"
    sol = pt.solve(qp, st)
    np.testing.assert_array_equal(sol.info.status.numpy(),
                                  np.asarray(ref.info.status))
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    assert (sol.info.status.numpy() == 3).all()
    for name in ("x", "y"):
        assert np.abs(getattr(sol, name).numpy()
                      - np.asarray(getattr(ref, name))).max() <= TOL


# -- sparse ADMM solves --

@pytest.mark.parametrize("storage", ["ell", "bcoo"])
def test_sparse_solve_matches_jax(data, storage):
    ref = qps.solve_jit(qps.make_sparse_qp(*_args(data), dtype=np.float64,
                                           storage=storage), qps.Settings(**LARGE))
    sol = pt.solve(pt.make_sparse_qp(*_args(data), dtype=np.float64,
                                     storage=storage, device="cpu"),
                   pt.Settings(**LARGE))
    assert int(sol.info.status) == 3
    _same(sol, ref)


def test_scaled_sparse_solve_matches_jax(data):
    Pj, qj, Aj, lj, uj, sj = jax_equilibrate(*_args(data), 10)
    ref = qps.solve_jit(qps.make_sparse_qp(Pj, qj, Aj, lj, uj, dtype=np.float64),
                        qps.Settings(**REL), scaling=sj)
    Pp, qp_, Ap, lp, up, sp_ = port_equilibrate(*_args(data), 10, device="cpu")
    sol = pt.solve(pt.make_sparse_qp(Pp, qp_, Ap, lp, up, dtype=np.float64,
                                     device="cpu"), pt.Settings(**REL),
                   scaling=sp_)
    assert int(sol.info.status) >= 2
    _same(sol, ref)
    # A warm start given in the original space round-trips the scaling.
    warm = pt.solve(pt.make_sparse_qp(Pp, qp_, Ap, lp, up, dtype=np.float64,
                                      device="cpu"), pt.Settings(**REL),
                    x0=sol.x.numpy(), z0=sol.z, y0=sol.y, scaling=sp_)
    assert int(warm.info.iterations) <= int(sol.info.iterations)
    assert np.abs(warm.x.numpy() - sol.x.numpy()).max() <= 1e-5


def test_kkt_settings_on_cg_match_jax(data):
    """tests/test_kkt.py:88-102's tight settings on the same instance."""
    ref = qps.solve_jit(jsp.make_sparse_qp(*_args(data), dtype=np.float64),
                        qps.Settings(**KKT))
    pq = pt.make_sparse_qp(*_args(data), dtype=np.float64, device="cpu")
    sol = pt.solve(pq, pt.Settings(**KKT))
    assert int(sol.info.status) >= 2
    _same(sol, ref)


def test_kkt_optimality_matches_jax_oracle(data):
    sol = pt.solve(pt.make_sparse_qp(*_args(data), dtype=np.float64,
                                     device="cpu"), pt.Settings(**LARGE))
    x, z, y = (t.numpy() for t in (sol.x, sol.z, sol.y))
    a = joracle.kkt_optimality(*_args(data), x, z, y)
    b = poracle.kkt_optimality(*_args(data), x, z, y)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert b.optimal(1e-4) and a.optimal(1e-4) == b.optimal(1e-4)
    assert poracle.kkt_optimality(*_args(data), x).res_dual == np.inf


# -- rows 13-15: the plain versions --

@pytest.mark.parametrize("which", ["P", "A", "At"])
def test_ell_matvec_plain_matches_jax_and_scipy(data, which):
    M = {"P": data.P, "A": data.A, "At": data.A.T.tocsr()}[which]
    vals, cols = jsp._to_ell(M, np.float64)
    v = np.random.default_rng(2).standard_normal(M.shape[1])
    ref = jsp._ell_matvec(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(v))
    got = spmv.ell_matvec(torch.tensor(vals), torch.tensor(cols), torch.tensor(v))
    assert spmv.ell_matvec.launches == 0  # the CPU runs the plain version
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-12
    assert np.abs(got.numpy() - M @ v).max() <= 1e-12


@pytest.mark.parametrize("which", ["P", "A", "At"])
def test_ell_matvec_prev_is_the_plain_version_on_cpu(data, which):
    """Row 13's previous kernel, kept as the new one's witness: on the CPU
    its wrapper runs the plain version, bit for bit, and launches nothing;
    in float32 too, as the new wrapper's does."""
    M = {"P": data.P, "A": data.A, "At": data.A.T.tocsr()}[which]
    v = np.random.default_rng(3).standard_normal(M.shape[1])
    for dtype in (np.float64, np.float32):
        vals, cols = (torch.tensor(a) for a in jsp._to_ell(M, dtype))
        vt = torch.tensor(v.astype(dtype))
        plain = spmv.ell_matvec_plain(vals, cols, vt)
        assert torch.equal(spmv.ell_matvec_prev(vals, cols, vt), plain)
        assert torch.equal(spmv.ell_matvec(vals, cols, vt), plain)
    assert spmv.ell_matvec_prev.launches == 0 and spmv.ell_matvec.launches == 0


@pytest.mark.parametrize("S,W", [(8, 128), (4, 256)])
@pytest.mark.parametrize("which", ["P", "A"])
def test_route_level_packers_match_the_probe(data, which, S, W):
    M = getattr(data, which).tocsr()
    a = routed_spmv_probe.pack_route_levels(M, S, W)
    b = rs.pack_route_levels(M, S, W)
    assert a[2:] == b[2:]
    for x, y in zip(a[:2], b[:2]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert routed_spmv_probe.chunk_tile_census(M, S) == rs.chunk_tile_census(M, S)


@pytest.mark.parametrize("which", ["P", "A"])
def test_row_routed_packer_matches_the_probe(data, which):
    M = getattr(data, which).tocsr()
    a = row_routed_probe.pack_row_routed(M)
    b = rs.pack_row_routed(M)
    assert a[3:] == b[3:]
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("which", ["P", "A"])
def test_routed_matvecs_match_scipy(data, which):
    M = getattr(data, which).tocsr()
    x = np.random.default_rng(3).standard_normal(M.shape[1])
    ref = M @ x
    xt = torch.tensor(x)
    for y in (rs.routed_matvec(M, xt, 8, rs.probe_width(M.shape[1])),
              rs.routed_matvec(M, xt, 4, 128),
              rs.row_routed_matvec(M, xt)):
        assert y.shape == ref.shape
        assert np.abs(y.numpy() - ref).max() <= 1e-12
    with pytest.raises(ValueError, match="cannot hold"):
        rs.routed_matvec(M, xt, 2, 128)


def test_route_level_plain_matches_the_probe_kernels(data):
    """routed_spmv_probe.py:189-192 (the micro kernel, per grid step g) and
    :299-304 (the route kernel, levels in t order), restated in jnp."""
    rng = np.random.default_rng(4)
    S, W, G = 8, 128, 6
    X = rng.standard_normal((S, W))
    idx = rng.integers(0, W, (G, S, W)).astype(np.int32)
    V = rng.standard_normal((G, S, W))
    want = np.stack([np.asarray(jnp.sum(
        jnp.asarray(V[g]) * jnp.take_along_axis(jnp.asarray(X),
                                                jnp.asarray(idx[g]), axis=1),
        axis=0)) for g in range(G)])
    got = rs.routed_levels_matvec(*(torch.tensor(a) for a in (X, idx, V)))
    assert np.abs(got.numpy() - want).max() <= 1e-12

    Pc = data.P.tocsr()
    Sr, Wr = 8, rs.probe_width(N)
    idxJ, Vl, T, ng = rs.pack_route_levels(Pc, Sr, Wr, np.float64)
    x = rng.standard_normal(N)
    Xd = np.pad(x, (0, Sr * Wr - N)).reshape(Wr, Sr).T
    rows = []
    for b in range(ng):
        acc = jnp.zeros((1, Wr))
        for t in range(T):
            gth = jnp.take_along_axis(jnp.asarray(Xd), jnp.asarray(idxJ[b, t]),
                                      axis=1)
            acc = acc + jnp.sum(jnp.asarray(Vl[b, t]) * gth, axis=0,
                                keepdims=True)
        rows.append(np.asarray(acc)[0])
    want = np.concatenate(rows)
    got = rs.routed_levels_matvec(torch.tensor(Xd.copy()), torch.tensor(idxJ),
                                  torch.tensor(Vl))
    assert np.abs(got.numpy().reshape(-1) - want).max() <= 1e-12
    assert np.abs(want[:N] - Pc @ x).max() <= 1e-12


def test_row_routed_plain_matches_the_probe_kernel(data):
    """row_routed_probe.py:204-209 restated in jnp on the whole packed
    matrix: every window's X row repeated L times, gathered, times V."""
    Pc = data.P.tocsr()
    idx, V, b_of_row, R, L, n_win, n_blk = rs.pack_row_routed(Pc, np.float64)
    x = np.random.default_rng(5).standard_normal(N)
    Xw = np.pad(x, (0, n_win * 128 - N)).reshape(n_win, 128)
    src = jnp.repeat(jnp.asarray(Xw), L, axis=0)
    want = np.asarray(jnp.asarray(V) * jnp.take_along_axis(
        src, jnp.asarray(idx), axis=1))
    got = rs.row_routed_rows(*(torch.tensor(a) for a in (Xw, idx, V)), L)
    np.testing.assert_array_equal(got.numpy(), want)
    y = np.zeros((n_blk, 128))
    np.add.at(y, b_of_row, want)
    assert np.abs(y.reshape(-1)[:N] - Pc @ x).max() <= 1e-12



# -- the routing kernels' device index and masked plain versions --

def _with_explicit_zeros(M):
    """M with a few stored entries set to explicit zeros (kept in CSR)."""
    M = M.tocsr().copy()
    M.data[::7] = 0.0
    return M


def _used_rows(idx_V_b):
    """The packer's used rows: slot r % L of window r // L is below that
    window's row count (the rows it numbered), from pack_row_routed's
    layout; the rest are padding."""
    V, b_of_row, R, L, n_win = idx_V_b
    rows = np.arange(R)
    counts = np.zeros(n_win, np.int64)
    filled = np.flatnonzero(np.any(V != 0, axis=1))
    np.maximum.at(counts, filled // L, filled % L + 1)
    return rows[(rows % L) < counts[rows // L]]


@pytest.mark.parametrize("which", ["P", "A"])
def test_row_routed_index_covers_every_used_row_once(data, which):
    """The block-major order and blk_ptr list every used row once, block by
    block, ascending r within each block, padding rows left out."""
    M = getattr(data, which).tocsr()
    idx, V, b_of_row, R, L, n_win, n_blk = rs.pack_row_routed(M, np.float64)
    mask, order, blk_ptr = rs.row_routed_index(V, b_of_row, n_blk)
    used = _used_rows((V, b_of_row, R, L, n_win))
    assert order.dtype == np.int32 and blk_ptr.dtype == np.int32
    assert blk_ptr.shape == (n_blk + 1,) and blk_ptr[0] == 0
    assert blk_ptr[-1] == len(order) == len(used) < R
    np.testing.assert_array_equal(np.sort(order), used)
    for b in range(n_blk):
        rows = order[blk_ptr[b]:blk_ptr[b + 1]]
        assert np.all(np.diff(rows) > 0)
        assert np.all(b_of_row[rows] == b)
    padding = np.setdiff1d(np.arange(R), used)
    assert not V[padding].any() and not b_of_row[padding].any()


@pytest.mark.parametrize("zeros", [False, True])
def test_occupancy_masks_match_the_packs(data, zeros):
    """Each mask bit is set exactly where the pack put a nonzero (an
    explicit zero of P leaves its bit clear), for the row-routed pack (R, 4),
    the route levels (G, T, S, W / 32) and a width that is not a multiple
    of 32."""
    M = _with_explicit_zeros(data.P) if zeros else data.P.tocsr()
    _, V, b_of_row, R, _, _, n_blk = rs.pack_row_routed(M, np.float64)
    mask, _, _ = rs.row_routed_index(V, b_of_row, n_blk)
    assert mask.dtype == np.uint32 and mask.shape == (R, 4)
    bits = (mask[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(bits.reshape(R, 128).astype(bool), V != 0)
    for S, W in ((8, rs.probe_width(N)), (4, 100)):
        if S * W < N:
            continue
        _, Vl, T, ng = rs.pack_route_levels(M, S, W, np.float64)
        m = rs.occupancy_mask(Vl)
        assert m.shape == (ng, T, S, -(-W // 32))
        got = rs.mask_bits(torch.from_numpy(m), W).numpy()
        np.testing.assert_array_equal(got, Vl != 0)
    if zeros:
        assert (M.data == 0).any() and (V != 0).sum() == M.count_nonzero()


@pytest.mark.parametrize("zeros", [False, True])
def test_row_routed_blocks_plain_matches_the_probe_rows_and_scipy(data, zeros):
    """The plain fused matvec in f64 equals row_routed_probe.py:204-209's
    rows (restated in jnp) summed with np.add.at, and scipy, within 1e-12;
    row_routed_matvec runs it here and launches nothing."""
    M = _with_explicit_zeros(data.P) if zeros else data.P.tocsr()
    idx, V, b_of_row, R, L, n_win, n_blk = rs.pack_row_routed(M, np.float64)
    mask, order, blk_ptr = rs.row_routed_index(V, b_of_row, n_blk)
    x = np.random.default_rng(6).standard_normal(N)
    Xw = np.pad(x, (0, n_win * 128 - N)).reshape(n_win, 128)
    src = jnp.repeat(jnp.asarray(Xw), L, axis=0)
    rows = np.asarray(jnp.asarray(V) * jnp.take_along_axis(
        src, jnp.asarray(idx), axis=1))
    want = np.zeros((n_blk, 128))
    np.add.at(want, b_of_row, rows)
    got = rs.row_routed_blocks(*(torch.from_numpy(a) for a in
                                 (Xw, idx, V, mask, order, blk_ptr)), L)
    assert got.dtype == torch.float64 and got.shape == (n_blk, 128)
    assert np.abs(got.numpy() - want).max() <= 1e-12
    assert np.abs(got.numpy().reshape(-1)[:N] - M @ x).max() <= 1e-12
    rs.row_routed_blocks.launches = rs.row_routed_rows.launches = 0
    y = rs.row_routed_matvec(M, torch.tensor(x))
    assert np.abs(y.numpy() - M @ x).max() <= 1e-12
    assert rs.row_routed_blocks.launches == rs.row_routed_rows.launches == 0


@pytest.mark.parametrize("zeros", [False, True])
def test_masked_route_levels_plain_is_the_unmasked_one(data, zeros):
    """The masked route-level plain version equals the unmasked one bit for
    bit in f64 (clear slots hold zeros; x is finite), on config 4's P packed
    at the probe's S, W and at a small W, and on the probe's micro shapes'
    full occupancy; routed_levels_prev runs the unmasked plain version here
    and launches nothing."""
    M = _with_explicit_zeros(data.P) if zeros else data.P.tocsr()
    x = torch.tensor(np.random.default_rng(7).standard_normal(N))
    for S, W in ((8, rs.probe_width(N)), (4, 128)):
        RL = rs.route_levels(M, S, W, "cpu", torch.float64)
        X = torch.nn.functional.pad(x, (0, S * W - N)).reshape(W, S).T
        X = X.contiguous()
        plain = rs.routed_levels_matvec_plain(X, RL.idxJ, RL.V)
        assert torch.equal(
            rs.routed_levels_matvec_plain(X, RL.idxJ, RL.V, RL.mask), plain)
        assert torch.equal(rs.routed_levels_matvec(X, RL.idxJ, RL.V, RL.mask),
                           plain)
        rs.routed_levels_prev.launches = 0
        assert torch.equal(rs.routed_levels_prev(X, RL.idxJ, RL.V), plain)
        assert rs.routed_levels_prev.launches == 0
        assert np.abs(rs.routed_matvec(RL, x).numpy() - M @ x.numpy()).max() <= 1e-12
    rng = np.random.default_rng(8)
    V = torch.tensor(rng.standard_normal((3, 8, 128)))
    idx = torch.tensor(rng.integers(0, 128, (3, 8, 128)).astype(np.int32))
    X = torch.tensor(rng.standard_normal((8, 128)))
    m = torch.from_numpy(rs.occupancy_mask(V.numpy()))
    assert int(m.to(torch.int64).min()) == 2 ** 32 - 1
    assert torch.equal(rs.routed_levels_matvec_plain(X, idx, V, m),
                       rs.routed_levels_matvec_plain(X, idx, V))
