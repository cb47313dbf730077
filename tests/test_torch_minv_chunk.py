"""The M^{-1}-form chunks with in-kernel refinement, for both solver families.

Each plain chunk (what the wrapper runs on a CPU tensor) against the JAX
package's Pallas chunk with sigma_free=False in interpret mode, on the same
numpy inputs with an inexact M^{-1} that each refinement pass visibly
corrects; the ADMM and prox solves with the default settings plus
fused_chunk (auto-padded; the sweep factor and the M^{-1} chunk in their
plain versions) against the JAX package's default unfused solves in f64; an
f32 ADMM solve against JAX's fused M^{-1} solve in interpret mode; and the
plans against JAX's at a shape its VMEM gate admits.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.models import plan as jax_plan
from quadraticprogramsolver_tpu.models import proxqp as jax_proxqp
from quadraticprogramsolver_tpu.ops.fused_admm import fused_admm_chunk as jax_admm_chunk
from quadraticprogramsolver_tpu.ops.fused_proxqp import (
    fused_proxqp_chunk as jax_prox_chunk)
from quadraticprogramsolver_tpu.problems.generator import ProblemClass

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.models import admm as pt_admm
from quadraticprogramsolver_tpu_torch.models import kkt as pt_kkt
from quadraticprogramsolver_tpu_torch.ops.fused_admm import (
    fused_admm_chunk_minv, fused_admm_chunk_minv_plain)
from quadraticprogramsolver_tpu_torch.ops.fused_proxqp import (
    fused_proxqp_chunk_minv, fused_proxqp_chunk_minv_plain)
from quadraticprogramsolver_tpu_torch.utils.interop import (
    prox_settings_from_dict, proxqp_from_numpy, qp_from_numpy, settings_from_dict)

B, N, M, K = 4, 128, 128, 5
ACTIVE = np.array([True, False, True, True])
#: Relative limit (to max(|JAX|, 1)): both sides are FP32 with another
#: summation order over at most 128 terms per product.
REL = 1e-5


def _t(*arrs):
    return tuple(torch.from_numpy(np.array(a, order="C"))
                 for a in arrs)


def _np(qp):
    return tuple(np.asarray(v) for v in (qp.P, qp.q, qp.A, qp.l, qp.u))


def _assert_rel(name, out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1.0)
    assert err <= REL, (name, err)


#: The M^{-1} operand of the chunk tests is the inverse of M + SHIFT*I, not
#: of M: an inexact inverse whose error each refinement pass (against the
#: true M, built from P, A and C) visibly corrects. An f32 inverse of M
#: itself is too accurate at these shapes for a pass to show: its correction
#: stays under REL.
SHIFT = 0.05


def _admm_inputs(seed):
    """(sigma, the f32 operands of the ADMM M^{-1} chunk, the f64 exact
    inverse of M) on a padded random_qp fleet at rho = 0.1."""
    qp = qps.pad_qp(qps.generate_batch(ProblemClass.RANDOM_QP, batch=B,
                                       num_elements=100, seed=0,
                                       dtype=np.float32), N, M)
    sigma = qps.Settings(rho=0.1).sigma_for(jnp.float32)
    P, A = np.asarray(qp.P, np.float64), np.asarray(qp.A, np.float64)
    Mn = P + sigma * np.eye(N) + 0.1 * np.swapaxes(A, 1, 2) @ A
    Minv = np.linalg.inv(Mn + SHIFT * np.eye(N))
    Minv = 0.5 * (Minv + np.swapaxes(Minv, 1, 2))   # both contractions agree
    rng = np.random.default_rng(seed)
    x, z, y = (rng.standard_normal((B, w)) for w in (N, M, M))
    rho_row = np.full((B, M), 0.1)
    f32 = [np.asarray(v, np.float32) for v in
           (Minv, qp.A, qp.P, qp.q, qp.l, qp.u, x, z, y, rho_row)]
    return sigma, f32 + [ACTIVE], np.linalg.inv(Mn)


def _prox_inputs(seed):
    """(sigma, the f32 operands of the prox M^{-1} chunk, the f64 exact
    inverse of M) on a split-form fleet with rho in [0.05, 0.5]."""
    me = mi = 128
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, N, N))
    P = np.swapaxes(X, 1, 2) @ X / N + np.eye(N)
    A = rng.standard_normal((B, me, N))
    C = rng.standard_normal((B, mi, N))
    q = rng.standard_normal((B, N))
    xf = rng.standard_normal((B, N))
    b = np.einsum("bij,bj->bi", A, xf)
    d = np.einsum("bij,bj->bi", C, xf) + 1.0
    rho, sigma = rng.uniform(0.05, 0.5, B), 1e-2
    Mn = P + sigma * np.eye(N) + rho[:, None, None] * (
        np.swapaxes(A, 1, 2) @ A + np.swapaxes(C, 1, 2) @ C)
    Minv = np.linalg.inv(Mn + SHIFT * np.eye(N))
    Minv = 0.5 * (Minv + np.swapaxes(Minv, 1, 2))   # both contractions agree
    x = rng.standard_normal((B, N))
    s = np.abs(rng.standard_normal((B, mi)))
    y = rng.standard_normal((B, me))
    z = np.abs(rng.standard_normal((B, mi)))
    f32 = [v.astype(np.float32) for v in (Minv, A, C, P, q, b, d, x, s, y, z, rho)]
    return sigma, f32 + [ACTIVE], np.linalg.inv(Mn)


#: ``lanes`` of the parity tests: at 2 the first pack holds the frozen lane
#: 1 beside the active lane 0, so JAX interleaves an active and a frozen
#: lane (fused_admm.py:197, fused_proxqp.py's pack) and the port, whose
#: kernels run one lane a cluster, must still give each lane its lanes-1
#: result.
LANES = [1, 2]


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("refine", [0, 1])
def test_plain_admm_minv_chunk_matches_jax_interpret(refine, lanes):
    sigma, arrs, _ = _admm_inputs(refine)
    kw = dict(K=K, alpha=1.6, sigma=sigma, refine=refine, lanes=lanes)
    ref = jax_admm_chunk(*arrs, interpret=True, **kw)
    ins = _t(*arrs)
    out = fused_admm_chunk_minv(*ins, **kw)
    plain = fused_admm_chunk_minv_plain(*ins, **dict(kw, lanes=1))
    for name, o, p, r in zip(("x", "z", "y", "x_prev", "z_prev", "Ax", "ATy"),
                             out, plain, ref):
        assert torch.equal(o, p), name       # on the CPU the wrapper is plain
        _assert_rel(name, o.numpy(), r)
    # The frozen lane passes through, with prev = current.
    x, z, y = arrs[6:9]
    for o, v in ((out[0], x), (out[3], x), (out[1], z), (out[4], z), (out[2], y)):
        np.testing.assert_array_equal(o[1].numpy(), v[1])
    assert not np.array_equal(out[0].numpy()[ACTIVE], x[ACTIVE])


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("refine", [0, 1])
def test_plain_prox_minv_chunk_matches_jax_interpret(refine, lanes):
    sigma, arrs, _ = _prox_inputs(10 + refine)
    kw = dict(K=K, sigma=sigma, refine=refine, lanes=lanes)
    ref = jax_prox_chunk(*arrs, interpret=True, **kw)
    ins = _t(*arrs)
    out = fused_proxqp_chunk_minv(*ins, **kw)
    plain = fused_proxqp_chunk_minv_plain(*ins, **dict(kw, lanes=1))
    for name, o, p, r, v0 in zip("xsyz", out, plain, ref, arrs[7:11]):
        assert torch.equal(o, p), name
        _assert_rel(name, o.numpy(), r)
        np.testing.assert_array_equal(o.numpy()[~ACTIVE], v0[~ACTIVE])


@pytest.mark.parametrize("family", ["admm", "prox"])
def test_refinement_pass_corrects_the_inexact_inverse(family):
    """On the parity tests' inputs, refine = 1 moves the chunk's outputs by
    far more than REL, so a chunk that skipped the pass would fail them; and
    each pass brings them at least 3x closer to the chunk run in f64 with
    the exact inverse of M."""
    if family == "admm":
        sigma, arrs, exact = _admm_inputs(0)
        chunk, kw = fused_admm_chunk_minv_plain, dict(K=K, alpha=1.6, sigma=sigma)
    else:
        sigma, arrs, exact = _prox_inputs(10)
        chunk, kw = fused_proxqp_chunk_minv_plain, dict(K=K, sigma=sigma)
    truth = chunk(*_t(exact, *(np.asarray(a, np.float64) for a in arrs[1:-1])),
                  torch.from_numpy(ACTIVE), refine=0, **kw)

    def rel(outs, refs):
        return max(float((o.double() - r).abs().max())
                   / max(float(r.abs().max()), 1.0) for o, r in zip(outs, refs))

    outs = [chunk(*_t(*arrs), refine=r, **kw) for r in range(3)]
    assert rel(outs[1], outs[0]) > 100 * REL
    errs = [rel(o, truth) for o in outs]
    assert errs[1] < errs[0] / 3 and errs[2] < errs[1] / 3, errs


def test_minv_chunk_wrappers_reject_other_devices():
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    act = torch.ones(2, dtype=torch.bool, device="meta")
    n, m = 128, 128
    with pytest.raises(ValueError, match="device"):
        fused_admm_chunk_minv(meta(2, n, n), meta(2, m, n), None, meta(2, n),
                              meta(2, m), meta(2, m), meta(2, n), meta(2, m),
                              meta(2, m), meta(2, m), act, K=2, alpha=1.6,
                              sigma=1e-4, refine=0)
    with pytest.raises(ValueError, match="device"):
        fused_proxqp_chunk_minv(meta(2, n, n), meta(2, m, n), meta(2, m, n),
                                None, meta(2, n), meta(2, m), meta(2, m),
                                meta(2, n), meta(2, m), meta(2, m), meta(2, m),
                                meta(2), act, K=2, sigma=1e-2, refine=0)


F64_CASES = [(ProblemClass.RANDOM_QP, 0), (ProblemClass.PORTFOLIO, 3)]


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "static"])
@pytest.mark.parametrize("cls,seed", F64_CASES, ids=lambda v: getattr(v, "value", v))
def test_f64_default_fused_admm_solve_matches_jax(cls, seed, adaptive):
    """Default Settings (M^{-1}, one refinement step) plus fused_chunk: the
    port pads to 128, factors by the sweep and iterates in the M^{-1} chunk;
    JAX runs its default unfused solve on the unpadded fleet."""
    qp_j = qps.generate_batch(cls, batch=4, num_elements=100, seed=seed,
                              dtype=np.float64)
    st_j = qps.Settings(max_iterations=4000, eps_abs=1e-6, eps_rel=1e-6,
                        rho=0.1, adaptive_rho=adaptive)
    ref = qps.solve_jit(qp_j, st_j)
    st_p = settings_from_dict({**dataclasses.asdict(st_j), "fused_chunk": True,
                               "require_fused": True})
    qp = qp_from_numpy(*_np(qp_j), device="cpu")
    p = pt.plan(qp, st_p)
    assert (p.chunk, p.factor, p.cache, p.padded) == (
        "fused_kernel", "sweep_inverse", "M_inv", (128, 128))
    sol = pt.solve(qp, st_p)
    np.testing.assert_array_equal(sol.info.status.numpy(), np.asarray(ref.info.status))
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    assert (sol.info.status.numpy() >= 2).all()
    for name in ("x", "y", "z"):
        a, b = getattr(sol, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-7, (name, np.abs(a - b).max())


def _split_np(n=20, me=4, mi=8, seed=0):
    """tests/test_proxqp.py's family: strictly convex, strictly feasible."""
    rng = np.random.default_rng(seed)
    Mx = rng.standard_normal((n, n))
    P = Mx @ Mx.T + 0.5 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((me, n))
    C = rng.standard_normal((mi, n))
    xf = rng.standard_normal(n)
    return P, q, A, A @ xf, C, C @ xf + rng.random(mi)


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "static"])
def test_f64_default_fused_prox_solve_matches_jax(adaptive):
    arrs = [np.stack(a) for a in zip(*(_split_np(seed=s) for s in range(4)))]
    st = qps.ProxQPSettings(max_iterations=1000, eps_abs=1e-8, eps_rel=1e-8,
                            rho=1.0, adaptive_rho=adaptive)
    ref = jax_proxqp.solve(qps.make_proxqp(*arrs), st)
    stp = prox_settings_from_dict({**dataclasses.asdict(st), "fused_chunk": True,
                                   "require_fused": True})
    p = proxqp_from_numpy(*arrs, device="cpu")
    plan = pt.plan_proxqp(p, stp)
    assert (plan.chunk, plan.factor, plan.cache, plan.padded) == (
        "fused_kernel", "sweep_inverse", "M_inv", (128, 128, 128))
    sol = pt.solve_proxqp(p, stp)
    np.testing.assert_array_equal(sol.info.status.numpy(), np.asarray(ref.info.status))
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    assert (sol.info.status.numpy() == 3).all()
    for name in "xysz":
        a, b = getattr(sol, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1e-7, (name, np.abs(a - b).max())


def test_f32_fused_minv_solve_matches_jax_interpret():
    """f32 at n = m = 128 (where JAX's VMEM gate admits the refine > 0
    chunk): the port on the CPU (sweep factor with the plain pivot, plain
    M^{-1} chunk) against JAX's fused M^{-1} solve in interpret mode."""
    qp_j = qps.pad_qp(qps.generate_batch(ProblemClass.RANDOM_QP, batch=4,
                                         num_elements=100, seed=0,
                                         dtype=np.float32), 128, 128)
    st_j = qps.Settings(rho=0.1, eps_abs=1e-4, eps_rel=1e-4,
                        max_iterations=1000, fused_chunk=True,
                        require_fused=True)
    assert jax_plan.plan(qp_j, st_j).chunk == "fused_pallas"
    ref = qps.solve_jit(qp_j, st_j)
    qp = qp_from_numpy(*_np(qp_j), dtype=torch.float32, device="cpu")
    sol = pt.solve(qp, settings_from_dict(dataclasses.asdict(st_j)))
    np.testing.assert_array_equal(sol.info.status.numpy(), np.asarray(ref.info.status))
    assert (sol.info.status.numpy() >= 2).all()
    assert np.abs(sol.x.numpy() - np.asarray(ref.x)).max() <= 1e-3


def test_fused_and_torch_minv_chunks_agree_in_the_solver():
    """The port's _run_chunk, M^{-1} form in f64: the fused branch (plain
    kernel) and the masked torch loop over models/kkt.py give the same
    iterates and the fused branch's A x, A'y are the check products."""
    qp_j = qps.pad_qp(qps.generate_batch(ProblemClass.RANDOM_QP, batch=B,
                                         num_elements=100, seed=2,
                                         dtype=np.float64), N, M)
    qp = qp_from_numpy(*_np(qp_j), device="cpu")
    kw = dict(max_iterations=100, rho=0.1, check_interval=K,
              kkt_backend=pt.KKTBackendKind.CHOLESKY, kkt_refinement_steps=2)
    fused, plain = pt.Settings(fused_chunk=True, **kw), pt.Settings(**kw)
    assert pt_admm._fused_chunk_ok(qp, fused)
    assert not pt_admm._fused_chunk_ok(qp, plain)
    rng = np.random.default_rng(5)
    x0, z0, y0 = (torch.from_numpy(rng.standard_normal((B, w))) for w in (N, M, M))
    backend = pt_kkt.get_backend(plain.kkt_backend, qp)
    state = pt_admm._init_state(qp, plain, backend, x0, z0, y0)
    state.status = torch.from_numpy(np.where(ACTIVE, 0, 3)).int()
    a = pt_admm._run_chunk(qp, fused, backend, state)
    b = pt_admm._run_chunk(qp, plain, backend, state)
    for u, v in zip(a[:5], b[:5]):
        assert float((u - v).abs().max()) <= 1e-12 * (float(v.abs().max()) + 1)
    Ax, ATy = a[6]
    assert float((Ax - qp.matvec_A(a[0])).abs().max()) <= 1e-12 * float(Ax.abs().max())
    assert float((ATy - qp.matvec_At(a[2])).abs().max()) <= 1e-12 * float(ATy.abs().max())


PLAN_CASES = {
    "m_inv": dict(fused_chunk=True),
    "sigma_free": dict(fused_chunk=True, kkt_refinement_steps=0,
                       sigma_free_rhs=True),
    "m_inv_unfused": dict(),
}
#: JAX's names for the same routes (the port names whether the pivot kernel
#: runs: on these shapes the sweep does).
FACTOR_NAMES = {"fused_pallas": "fused_kernel", "xla": "torch",
                "xla_inverse": "sweep_inverse", "xla_gj_sweep": "gj_sweep"}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_admm_plan_matches_jax(case):
    st_j = qps.Settings(**PLAN_CASES[case])
    st_p = settings_from_dict(dataclasses.asdict(st_j))
    for n, m in ((128, 128), (100, 60)):
        arrs = [np.zeros(s, np.float32) for s in
                ((8, n, n), (8, n), (8, m, n), (8, m), (8, m))]
        jpl = jax_plan.plan(qps.make_qp(*arrs), st_j)
        ppl = pt.plan(pt.make_qp(*arrs, device="cpu"), st_p)
        for f in ("chunk", "factor", "cache", "padded", "lanes",
                  "dot_precision", "fallback_reasons"):
            jv, pv = getattr(jpl, f), getattr(ppl, f)
            if f == "factor" and n % 128 and jpl.padded is None:
                jv = {"xla_inverse": "torch_inverse"}.get(jv, jv)  # Cholesky
            jv = FACTOR_NAMES.get(jv, jv)
            assert pv == jv, (f, pv, jv)


@pytest.mark.parametrize("case", ["m_inv", "m_inv_unfused"])
def test_prox_plan_matches_jax(case):
    st = qps.ProxQPSettings(**PLAN_CASES[case])
    stp = prox_settings_from_dict(dataclasses.asdict(st))
    for n, me, mi in ((128, 128, 128), (100, 4, 8)):
        arrs = [np.zeros(s, np.float32) for s in
                ((8, n, n), (8, n), (8, me, n), (8, me), (8, mi, n), (8, mi))]
        jpl = jax_plan.plan_proxqp(qps.make_proxqp(*arrs), st)
        ppl = pt.plan_proxqp(pt.make_proxqp(*arrs, device="cpu"), stp)
        for f in ("chunk", "factor", "cache", "padded", "lanes",
                  "dot_precision", "fallback_reasons"):
            jv, pv = getattr(jpl, f), getattr(ppl, f)
            if f == "factor" and n % 128 and jpl.padded is None:
                jv = {"xla_inverse": "torch_inverse"}.get(jv, jv)  # Cholesky
            jv = FACTOR_NAMES.get(jv, jv)
            assert pv == jv, (f, pv, jv)


def test_small_fleet_plans_cholesky_and_require_fused_says_why():
    g = torch.Generator().manual_seed(9)
    qp = pt.make_qp(*(torch.randn(s, generator=g) for s in
                      ((2, 128, 128), (2, 128), (2, 128, 128), (2, 128),
                       (2, 128))))
    st = pt.Settings(fused_chunk=True)
    p = pt.plan(qp, st)
    assert (p.chunk, p.factor) == ("fused_kernel", "torch_inverse")
    assert any("B=2 < 4" in r for r in p.fallback_reasons)
    with pytest.raises(ValueError, match="B=2 < 4"):
        pt.solve(qp, dataclasses.replace(st, require_fused=True))
