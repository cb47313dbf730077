"""The port's Ruiz equilibration and Anderson acceleration against the JAX
package's.

f64 on the CPU unless a test says otherwise: ``equilibrate`` (P, q, A, l,
u, d, e, c within 1e-12, with +-inf bounds and the zero rows of padding);
the Anderson core (``aa_mix``, ``aa_gamma``, ``aa_commit`` on seeded inputs,
within 1e-12); whole ``anderson_memory=8`` solves of both families (identical
statuses and iterations, x and y within 1e-7, the residual history within
1e-6); tests/test_anderson.py's Lasso fact; and one f32 scaled fused solve against JAX's fused path in
interpret mode (tests/test_torch_admm.py's f32 tolerance).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.models import anderson as janderson
from quadraticprogramsolver_tpu.models import scaling as jscaling
from quadraticprogramsolver_tpu.problems.generator import ProblemClass

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.models import anderson as panderson
from quadraticprogramsolver_tpu_torch.models import scaling as pscaling
from quadraticprogramsolver_tpu_torch.utils.interop import (
    prox_settings_from_dict, qp_from_numpy, settings_from_dict)

#: The residual trace's bar: mid-solve residuals (up to O(10)) carry the
#: iterates' rounding apart, 1.6e-7 at most on these fleets (a static-rho
#: prox lane at check 10).
HISTORY_TOL = 1e-6
SMALL_M = {ProblemClass.LASSO: 30, ProblemClass.HUBER: 30,
           ProblemClass.SVM: 30, ProblemClass.INEQUALITY_QP: 30}


def _np(qp):
    return tuple(np.asarray(v) for v in (qp.P, qp.q, qp.A, qp.l, qp.u))


def _close(a, b, tol, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind in "bi":
        assert np.array_equal(a, b), what
        return
    assert np.array_equal(np.isinf(a), np.isinf(b)), what
    fin = np.isfinite(a)
    assert np.abs(a[fin] - b[fin]).max(initial=0.0) <= tol, (
        what, np.abs(a[fin] - b[fin]).max())


@pytest.mark.parametrize("batched", [True, False], ids=["fleet", "single"])
def test_equilibrate_matches_jax(batched):
    """HUBER has +inf upper bounds; the pad adds all-zero rows with +-inf
    bounds and unit-diagonal variables, which must stay inert (scale 1)."""
    datas = [qps.generate_random_qp(ProblemClass.HUBER, 8, 12, seed=s)
             for s in (0, 1, 2)]
    qps_j = [qps.pad_qp(qps.make_qp(*d.dense()), 48, 40) for d in datas]
    qp_j = qps.stack_qps(qps_j) if batched else qps_j[0]
    qp = pt.make_qp(*_np(qp_j), device="cpu")
    assert np.isinf(np.asarray(qp_j.u)).any() and np.isinf(np.asarray(qp_j.l)).any()
    s_j, d_j = jscaling.equilibrate(qp_j, 10)
    s_p, d_p = pscaling.equilibrate(qp, 10)
    for name, a, b in zip("PqAlu", _np(s_j), s_p.tensors()):
        _close(a, b.numpy(), 1e-12, name)
    for name in "dec":
        _close(getattr(d_j, name), getattr(d_p, name).numpy(), 1e-12, name)
    # The padding's rows and columns keep scale 1.
    assert (d_p.e[..., 36:] == 1).all() and (d_p.d[..., 44:] == d_p.d[..., 44:]).all()


def _aa_inputs(seed, B=5, d=7, mem=4):
    rng = np.random.default_rng(seed)
    aa = {"S": rng.standard_normal((B, mem, d)),
          "F": rng.standard_normal((B, mem, d)),
          "prev_s": rng.standard_normal((B, d)),
          "prev_f": rng.standard_normal((B, d)),
          "count": np.array([0, 1, 3, 4, 9][:B], np.int32)}
    s_in = rng.standard_normal((B, d))
    s_plain = s_in + 0.1 * rng.standard_normal((B, d))
    return aa, s_in, s_plain


def _to_jax(aa):
    return {k: jnp.asarray(v) for k, v in aa.items()}


def _to_torch(aa):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in aa.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_aa_mix_gamma_commit_match_jax(seed):
    mem, reg = 4, 1e-8
    aa, s_in, s_plain = _aa_inputs(seed, mem=mem)
    out_j = janderson.aa_mix(_to_jax(aa), jnp.asarray(s_in),
                             jnp.asarray(s_plain), mem, reg)
    out_p = panderson.aa_mix(_to_torch(aa), torch.from_numpy(s_in),
                             torch.from_numpy(s_plain), mem, reg)
    for name, a, b in zip(("s_aa", "S", "F", "f", "have_prev"), out_j, out_p):
        _close(a, b.numpy(), 1e-12, name)
    # aa_gamma alone, on the Gram of the pushed history.
    F = np.asarray(out_j[2])
    G = F @ F.transpose(0, 2, 1)
    rhs = np.einsum("bid,bd->bi", F, np.asarray(out_j[3]))
    g_j = janderson.aa_gamma(jnp.asarray(G), jnp.asarray(rhs), mem, reg,
                             jnp.float64)
    g_p = panderson.aa_gamma(torch.from_numpy(G), torch.from_numpy(rhs), mem,
                             reg, torch.float64)
    _close(g_j, g_p.numpy(), 1e-12, "gamma")
    # An all-zero history gives gamma = 0 (the plain iterate).
    z = panderson.aa_gamma(torch.zeros(2, mem, mem, dtype=torch.float64),
                           torch.zeros(2, mem, dtype=torch.float64), mem, reg,
                           torch.float64)
    assert not z.any()
    active = np.array([True, True, False, True, True])
    rejected = np.array([False, True, False, False, True])
    c_j = janderson.aa_commit(_to_jax(aa), out_j[1], out_j[2],
                              jnp.asarray(s_in), out_j[3],
                              jnp.asarray(active), jnp.asarray(rejected))
    c_p = panderson.aa_commit(_to_torch(aa), out_p[1], out_p[2],
                              torch.from_numpy(s_in), out_p[3],
                              torch.from_numpy(active),
                              torch.from_numpy(rejected))
    for k in c_j:
        _close(c_j[k], c_p[k].numpy(), 1e-12, k)
    r_j = janderson.reset_aa(c_j, jnp.asarray(rejected | ~active))
    r_p = panderson.reset_aa(c_p, torch.from_numpy(rejected | ~active))
    for k in r_j:
        _close(r_j[k], r_p[k].numpy(), 0.0, k)


def _box_fleet(cls, seed, n=20):
    m = SMALL_M.get(cls, 0)
    datas = [qps.generate_random_qp(cls, n, m, seed=seed + i) for i in range(3)]
    qp_j = qps.stack_qps([qps.make_qp(*d.dense()) for d in datas], pad=True)
    return qp_j, pt.make_qp(*_np(qp_j), device="cpu")


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "static"])
@pytest.mark.parametrize("cls", [ProblemClass.INEQUALITY_QP, ProblemClass.LASSO],
                         ids=lambda c: c.value)
def test_admm_anderson_solve_matches_jax(cls, adaptive):
    qp_j, qp = _box_fleet(cls, 0, n=10)
    st = qps.Settings(max_iterations=20_000, eps_abs=1e-7, eps_rel=1e-7,
                      rho=0.1, adaptive_rho=adaptive, anderson_memory=8,
                      record_history=True)
    ref = qps.solve_jit(qp_j, st)
    sol = pt.solve(qp, settings_from_dict(dataclasses.asdict(st)))
    np.testing.assert_array_equal(sol.info.status.numpy(), np.asarray(ref.info.status))
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    assert (sol.info.status.numpy() >= 2).all()
    for name in ("x", "y", "z"):
        dev = np.abs(getattr(sol, name).numpy() - np.asarray(getattr(ref, name))).max()
        assert dev <= 1e-7, (name, dev)
    h = sol.info.history
    assert h["res_prim"].shape == (st.num_checks, 3)
    _close(np.asarray(ref.info.history["res_prim"]), h["res_prim"].numpy(),
           HISTORY_TOL, "history")


def test_anderson_scaled_solve_matches_jax():
    """Anderson's safeguard on the unscaled margins of a Ruiz-scaled solve."""
    qp_j, qp = _box_fleet(ProblemClass.HUBER, 0, n=10)
    st = qps.Settings(max_iterations=20_000, eps_abs=1e-7, eps_rel=1e-7,
                      rho=0.1, anderson_memory=5, scaling_iters=10)
    ref = qps.solve_jit(qp_j, st)
    sol = pt.solve(qp, settings_from_dict(dataclasses.asdict(st)))
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    np.testing.assert_array_equal(sol.info.status.numpy(), np.asarray(ref.info.status))
    assert np.abs(sol.x.numpy() - np.asarray(ref.x)).max() <= 1e-7


def _prox_fleet(seed, B=4, n=16, me=4, mi=8):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    P = M @ M.transpose(0, 2, 1) / n + np.eye(n)
    q = rng.standard_normal((B, n))
    A = rng.standard_normal((B, me, n))
    C = rng.standard_normal((B, mi, n))
    x0 = rng.standard_normal((B, n))
    b = np.einsum("bij,bj->bi", A, x0)
    d = np.einsum("bij,bj->bi", C, x0) + rng.random((B, mi))
    arrs = (P, q, A, b, C, d)
    return (qps.ProxQPProblem(*(jnp.asarray(v) for v in arrs)),
            pt.make_proxqp(*arrs, device="cpu"))


def _lasso_prox(seed):
    """LASSO lowered onto the split form (equalities l = u, the rest one
    sided), so the prox family meets the same class."""
    d = qps.generate_random_qp(ProblemClass.LASSO, 10, 30, seed=seed)
    P, q, A, l, u = d.dense()
    eq = l == u
    C = np.concatenate([A[~eq & np.isfinite(u)], -A[~eq & np.isfinite(l)]])
    dd = np.concatenate([u[~eq & np.isfinite(u)], -l[~eq & np.isfinite(l)]])
    arrs = tuple(v[None] for v in (P + 1e-3 * np.eye(len(q)), q, A[eq], l[eq],
                                   C, dd))
    return (qps.ProxQPProblem(*(jnp.asarray(v) for v in arrs)),
            pt.make_proxqp(*arrs, device="cpu"))


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "static"])
@pytest.mark.parametrize("family", ["random", "lasso"])
def test_prox_anderson_solve_matches_jax(family, adaptive):
    pj, pp = _prox_fleet(3) if family == "random" else _lasso_prox(0)
    st = qps.ProxQPSettings(max_iterations=3000, eps_abs=1e-8, eps_rel=1e-8,
                            adaptive_rho=adaptive, anderson_memory=8,
                            record_history=True)
    ref = qps.solve_proxqp(pj, st)
    sol = pt.solve_proxqp(pp, prox_settings_from_dict(dataclasses.asdict(st)))
    np.testing.assert_array_equal(sol.info.status.numpy(), np.asarray(ref.info.status))
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    assert (sol.info.status.numpy() == 3).all()
    for name in ("x", "y", "s", "z"):
        dev = np.abs(getattr(sol, name).numpy() - np.asarray(getattr(ref, name))).max()
        assert dev <= 1e-7, (name, dev)
    _close(np.asarray(ref.info.history["res_dual"]),
           sol.info.history["res_dual"].numpy(), HISTORY_TOL, "history")
    assert sol.info.history["rho"].shape == (st.num_checks,) + pp.batch_shape


def test_lasso_seed0_anderson_fact_reproduced():
    """tests/test_anderson.py's pin: on lasso n=50 seed 0 guarded Anderson
    takes MORE iterations than plain, and both land on the oracle."""
    from quadraticprogramsolver_tpu.utils.oracle import solve_qp_reference

    data = qps.generate_random_qp(ProblemClass.LASSO, 10, 30, seed=0)
    assert data.n == 50
    ref = solve_qp_reference(data.P, data.q, data.A, data.l, data.u,
                             eps_abs=1e-9, eps_rel=1e-9, rho=0.1)
    assert ref.status == 3
    qp = pt.make_qp(*data.dense(), device="cpu")
    st = pt.Settings(max_iterations=20_000, eps_abs=1e-7, eps_rel=1e-7,
                     rho=0.1, check_interval=25)
    plain = pt.solve(qp, st)
    aa = pt.solve(qp, dataclasses.replace(st, anderson_memory=8))
    for sol in (plain, aa):
        assert int(sol.info.status) >= pt.Status.SOLVED_ADMM
        assert np.abs(sol.x.numpy() - ref.x).max() <= 1e-5
    assert int(aa.info.iterations) > int(plain.info.iterations)
    jp = qps.solve_jit(qps.make_qp(*data.dense()), qps.Settings(
        **{**dataclasses.asdict(st), "kkt_backend": qps.KKTBackendKind.AUTO}))
    ja = qps.solve_jit(qps.make_qp(*data.dense()), qps.Settings(
        **{**dataclasses.asdict(st), "kkt_backend": qps.KKTBackendKind.AUTO,
           "anderson_memory": 8}))
    assert (int(plain.info.iterations), int(aa.info.iterations)) == (
        int(jp.info.iterations), int(ja.info.iterations))


def test_f32_scaled_fused_solve_matches_jax_interpret():
    """Ruiz scaling on the fused sigma-free path in f32: the port's kernels'
    plain versions against JAX's fused path in interpret mode."""
    qp_j = qps.pad_qp(qps.generate_batch(ProblemClass.RANDOM_QP, batch=4,
                                         num_elements=100, seed=0,
                                         dtype=np.float32), 128, 128)
    st_j = qps.Settings(rho=0.1, eps_abs=1e-5, eps_rel=1e-5,
                        max_iterations=2000, kkt_refinement_steps=0,
                        sigma_free_rhs=True, sigma=1e-7, fused_factor=True,
                        fused_chunk=True, scaling_iters=10)
    ref = qps.solve_jit(qp_j, st_j)
    qp = qp_from_numpy(*_np(qp_j), dtype=torch.float32, device="cpu")
    st = settings_from_dict(dataclasses.asdict(st_j))
    assert pt.plan(qp, st).chunk == "fused_kernel"
    sol = pt.solve(qp, st)
    np.testing.assert_array_equal(sol.info.status.numpy(), np.asarray(ref.info.status))
    assert (sol.info.status.numpy() >= 2).all()
    assert np.abs(sol.x.numpy() - np.asarray(ref.x)).max() <= 1e-3


def test_scaling_pads_before_equilibrating():
    """With the auto-pad, equilibration runs on the padded problem: the
    port's solve of a 100/50 fleet equals its solve of the pre-padded one
    bit for bit (pad first, as the JAX package does)."""
    qp = pt.generate_batch(pt.ProblemClass.RANDOM_QP, 4, 100, seed=1,
                           dtype=np.float64, device="cpu")
    st = pt.Settings(max_iterations=2000, eps_abs=1e-6, eps_rel=1e-6, rho=0.1,
                     kkt_refinement_steps=0, sigma_free_rhs=True,
                     fused_factor=True, fused_chunk=True, scaling_iters=10)
    assert pt.plan(qp, st).padded == (128, 128)
    a = pt.solve(qp, st)
    b = pt.solve(pt.pad_qp(qp, 128, 128), st)
    assert torch.equal(a.info.iterations, b.info.iterations)
    assert torch.equal(a.x, b.x[:, :100]) and torch.equal(a.y, b.y[:, :50])
    assert (a.info.status >= 2).all()
