"""The port's prox-ALM solver against the JAX package's models/proxqp.py.

f64 on the CPU: identical statuses and iteration counts, and x, y, s, z
within 1e-7, under the default settings (M^{-1} with one refinement step,
KKT warm start), sigma-free, early_exit=False, adaptive and static rho, the
fused knobs (auto-padded; plain versions of the kernels) against JAX's
unfused sigma-free path, a prepared factor and the segmented solve. f32:
the fused sigma-free slice against the JAX fused path in interpret mode.
Plus the certificates, padding, plan and settings contracts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.core.problem import pad_proxqp as jax_pad_proxqp
from quadraticprogramsolver_tpu.models import plan as jax_plan
from quadraticprogramsolver_tpu.models import proxqp as jax_proxqp

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.core import settings as pt_settings
from quadraticprogramsolver_tpu_torch.models import proxqp as pt_proxqp
from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
    device_prox_fleet)
from quadraticprogramsolver_tpu_torch.utils.interop import (
    prox_settings_from_dict, prox_solution_to_numpy, proxqp_from_numpy)

TOL = 1e-7


def _split_np(n=20, me=4, mi=8, seed=0):
    """tests/test_proxqp.py's family: strictly convex, strictly feasible."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    P = M @ M.T + 0.5 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((me, n))
    C = rng.standard_normal((mi, n))
    xf = rng.standard_normal(n)
    return P, q, A, A @ xf, C, C @ xf + rng.random(mi)


def _fleet_np(seeds=(0, 1, 2, 3), dtype=np.float64, **kw):
    arrs = [np.stack(a) for a in zip(*(_split_np(seed=s, **kw) for s in seeds))]
    return [a.astype(dtype) for a in arrs]


def _pair(arrs, dtype=np.float64):
    tdtype = {np.float64: torch.float64, np.float32: torch.float32}[dtype]
    return (qps.make_proxqp(*arrs, dtype=dtype),
            proxqp_from_numpy(*arrs, device="cpu", dtype=tdtype))


def _port_settings(st, **extra):
    return prox_settings_from_dict({**dataclasses.asdict(st), **extra})


def _assert_same(sol, ref, tol=TOL):
    np.testing.assert_array_equal(sol.info.status.numpy(),
                                  np.asarray(ref.info.status))
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    for name in "xysz":
        a, b = getattr(sol, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= tol, (name, np.abs(a - b).max())


BASE = dict(max_iterations=4000, eps_abs=1e-9, eps_rel=1e-9)
F64_CASES = {
    "defaults": {},
    "sigma_free": dict(kkt_refinement_steps=0, sigma_free_rhs=True),
    "no_early_exit": dict(early_exit=False, max_iterations=500),
    "static_rho": dict(adaptive_rho=False, max_iterations=1000),
    "zero_start_static_sf": dict(kkt_warm_start=False, adaptive_rho=False,
                                 kkt_refinement_steps=0, sigma_free_rhs=True,
                                 rho=10.0, max_iterations=1000),
}


@pytest.mark.parametrize("case", list(F64_CASES))
def test_f64_solve_matches_jax(case):
    j, p = _pair(_fleet_np())
    st = qps.ProxQPSettings(**{**BASE, **F64_CASES[case]})
    ref = jax_proxqp.solve(j, st)
    sol = pt.solve_proxqp(p, _port_settings(st))
    _assert_same(sol, ref)
    if st.early_exit:
        # The last rho update divides residuals of ~1e-10 (eps 1e-9), which
        # carry a relative rounding of ~1e-6 whatever the summation order.
        # Without early exit, converged lanes go on adapting rho on residuals
        # at the rounding floor, so rho itself is noise there.
        np.testing.assert_allclose(sol.info.rho.numpy(),
                                   np.asarray(ref.info.rho), rtol=1e-4)
    np.testing.assert_array_equal(sol.info.converged.numpy(),
                                  np.asarray(ref.info.converged))


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "static"])
def test_f64_fused_knobs_match_jax(adaptive):
    """The port's fused path (auto-padded to 128, plain kernel versions on
    the CPU) against JAX's unfused sigma-free solve of the unpadded fleet."""
    j, p = _pair(_fleet_np())
    st = qps.ProxQPSettings(max_iterations=1000, eps_abs=1e-8, eps_rel=1e-8,
                            rho=1.0, adaptive_rho=adaptive,
                            kkt_refinement_steps=0, sigma_free_rhs=True)
    ref = jax_proxqp.solve(j, st)
    stp = _port_settings(st, fused_chunk=True, require_fused=True)
    plan = pt.plan_proxqp(p, stp)
    assert (plan.chunk, plan.factor, plan.padded) == (
        "fused_kernel", "fused_slab", (128, 128, 128))
    sol = pt.solve_proxqp(p, stp)
    _assert_same(sol, ref)
    assert (sol.info.status.numpy() == 3).all()


def test_primal_infeasible_status_4():
    P, q = np.eye(4), np.zeros(4)
    A = np.zeros((2, 4)); A[0, 0] = A[1, 0] = 1.0
    C = np.zeros((1, 4)); C[0, 1] = 1.0
    arrs = (P, q, A, np.array([0.0, 1.0]), C, np.array([1.0]))
    j, p = _pair(arrs)
    st = qps.ProxQPSettings(max_iterations=2000, kkt_warm_start=False)
    ref = jax_proxqp.solve(j, st)
    sol = pt.solve_proxqp(p, _port_settings(st))
    assert int(sol.info.status) == int(ref.info.status) == 4
    assert int(sol.info.iterations) == int(ref.info.iterations)
    off = pt.solve_proxqp(p, _port_settings(st, check_infeasibility=False))
    assert int(off.info.status) == 1


def test_dual_infeasible_status_5():
    P = np.zeros((3, 3)); P[1, 1] = P[2, 2] = 1.0
    A = np.zeros((1, 3)); A[0, 1] = 1.0
    C = np.zeros((1, 3)); C[0, 0] = -1.0
    arrs = (P, np.array([-1.0, 0.0, 0.0]), A, np.zeros(1), C, np.zeros(1))
    j, p = _pair(arrs)
    st = qps.ProxQPSettings(max_iterations=2000, kkt_warm_start=False)
    ref = jax_proxqp.solve(j, st)
    sol = pt.solve_proxqp(p, _port_settings(st))
    assert int(sol.info.status) == int(ref.info.status) == 5
    assert int(sol.info.iterations) == int(ref.info.iterations)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_pad_proxqp_matches_jax(batch):
    arrs = _fleet_np(seeds=range(max(1, int(np.prod(batch)))))
    if not batch:
        arrs = [a[0] for a in arrs]
    j, p = _pair(arrs)
    jp_, pp = jax_pad_proxqp(j, 32, 8, 16), pt.pad_proxqp(p, 32, 8, 16)
    for name in ("P", "q", "A", "b", "C", "d"):
        np.testing.assert_array_equal(getattr(pp, name).numpy(),
                                      np.asarray(getattr(jp_, name)))
    assert pt.pad_proxqp(p, 20, 4, 8) is p
    with pytest.raises(ValueError):
        pt.pad_proxqp(p, 16, 4, 8)


def test_auto_padded_solve_equals_pre_padded():
    _, p = _pair(_fleet_np(n=100, me=7, mi=33))
    st = pt.ProxQPSettings(max_iterations=1000, eps_abs=1e-8, eps_rel=1e-8,
                           kkt_refinement_steps=0, sigma_free_rhs=True,
                           fused_chunk=True, kkt_warm_start=False)
    auto = pt.solve_proxqp(p, st)
    padded = pt.pad_proxqp(p, 128, 128, 128)
    x0 = torch.zeros(4, 128, dtype=torch.float64)
    s0 = torch.nn.functional.pad(torch.clamp_min(p.d, 0.0), (0, 128 - 33))
    pre = pt.solve_proxqp(padded, st, init=(x0, x0[:, :128], s0, 0 * s0))
    assert auto.x.shape == (4, 100) and auto.s.shape == (4, 33)
    assert torch.equal(auto.info.iterations, pre.info.iterations)
    assert torch.equal(auto.info.status, pre.info.status)
    for name, w in (("x", 100), ("y", 7), ("s", 33), ("z", 33)):
        a, b = getattr(auto, name), getattr(pre, name)[..., :w]
        assert float((a - b).abs().max()) <= 1e-12, name
    assert not pre.x[:, 100:].any() and not pre.z[:, 33:].any()


@pytest.mark.parametrize("sigma_free", [False, True], ids=["m_inv", "sigma_free"])
def test_prepared_solve_matches_jax(sigma_free):
    j, p = _pair(_fleet_np())
    st = qps.ProxQPSettings(max_iterations=4000, eps_abs=1e-9, eps_rel=1e-9,
                            rho=3.0, sigma_free_rhs=sigma_free,
                            kkt_refinement_steps=0 if sigma_free else 1)
    prep_j = jax_proxqp.prepare(j, st)
    ref = jax_proxqp.solve(j, st, None, None, prep_j)
    stp = _port_settings(st)
    prep = pt.prepare_proxqp(p, stp)
    assert isinstance(prep, pt.PreparedProxFactor)
    sol = pt.solve_proxqp(p, stp, prepared=prep)
    _assert_same(sol, ref)
    # A prepared solve is not padded: require_fused says so up front.
    with pytest.raises(ValueError, match="prepared solve is not padded"):
        pt.solve_proxqp(p, _port_settings(
            st, kkt_refinement_steps=0, sigma_free_rhs=True, fused_chunk=True,
            require_fused=True), prepared=prep)


def test_solve_segmented_matches_jax():
    j, p = _pair(_fleet_np(n=24, me=4, mi=8, seeds=(5, 6)))
    st = qps.ProxQPSettings(max_iterations=600, eps_abs=1e-9, eps_rel=1e-8,
                            check_interval=25, kkt_warm_start=False)
    ref = jax_proxqp.solve_segmented(j, st, segment_iterations=100)
    sol = pt_proxqp.solve_segmented(p, _port_settings(st),
                                    segment_iterations=100)
    _assert_same(sol, ref)


def test_f32_fused_slice_matches_jax_interpret():
    """The fused sigma-free slice in f32: the port on the CPU (plain
    kernels) against JAX's fused chunk and slab factor in interpret mode.

    n = 256 rather than tests/test_proxqp.py's n = me = 128: with as many
    equality rows as variables x is pinned by a square random A, whose f32
    conditioning puts each lane's exit at the noise level (both
    implementations then end ~1e-4 from the f64 solution, at different
    checks)."""
    arrs = _fleet_np(seeds=(0, 1), dtype=np.float32, n=256, me=128, mi=128)
    j, p = _pair(arrs, np.float32)
    st = qps.ProxQPSettings(max_iterations=500, eps_abs=1e-5, eps_rel=1e-5,
                            kkt_refinement_steps=0, sigma_free_rhs=True,
                            fused_chunk=True)
    ref = jax_proxqp.solve(j, st)
    stp = _port_settings(st)
    assert pt.plan_proxqp(p, stp).chunk == "fused_kernel"
    sol = pt.solve_proxqp(p, stp)
    np.testing.assert_array_equal(sol.info.status.numpy(),
                                  np.asarray(ref.info.status))
    assert (sol.info.status.numpy() == 3).all()
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    x_ref = np.asarray(ref.x)
    dev = np.abs(sol.x.numpy() - x_ref).max() / (np.abs(x_ref).max() + 1.0)
    assert dev <= 1e-4, dev


def test_warm_start_matches_jax():
    j, p = _pair(_fleet_np())
    for a, b in zip(pt_proxqp.warm_start(p), jax_proxqp.warm_start(j)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-10


def test_plan_matches_jax_and_require_fused_raises_on_every_gate():
    sf = dict(kkt_refinement_steps=0, sigma_free_rhs=True, fused_chunk=True)
    jst, pst = qps.ProxQPSettings(**sf), pt.ProxQPSettings(**sf)
    for B, n, me, mi in ((8, 128, 128, 128), (8, 100, 4, 8), (8, 128, 0, 128)):
        arrs = [np.zeros(s, np.float32) for s in
                ((B, n, n), (B, n), (B, me, n), (B, me), (B, mi, n), (B, mi))]
        jpl = jax_plan.plan_proxqp(qps.make_proxqp(*arrs), jst)
        ppl = pt.plan_proxqp(pt.make_proxqp(*arrs, device="cpu"), pst)
        for f in ("chunk", "factor", "cache", "padded", "lanes",
                  "dot_precision", "fallback_reasons"):
            jv, pv = getattr(jpl, f), getattr(ppl, f)
            jv = {"fused_pallas": "fused_kernel", "xla": "torch",
                  "xla_gj_sweep": "gj_sweep"}.get(jv, jv)
            assert pv == jv, (f, pv, jv)
    ok = device_prox_fleet(4, 128, 128, 128,
                           generator=torch.Generator().manual_seed(0))
    st = pt.ProxQPSettings(require_fused=True, max_iterations=50, **sf)
    assert pt.plan_proxqp(ok, st).fallback_reasons == ()
    bad = {
        "device": ok.to("meta"),
        "float16": ok.to(torch.float16),
        "one batch axis": pt.ProxQPProblem(*(t[None] for t in ok.tensors())),
        "B=2 < 4": pt.ProxQPProblem(*(t[:2] for t in ok.tensors())),
    }
    for match, prob in bad.items():
        with pytest.raises(ValueError, match=match):
            pt.solve_proxqp(prob, st)
    pt.solve_proxqp(ok, st)  # every gate passes: no raise


def test_settings_fields_defaults_and_validators_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(qps.ProxQPSettings)}
    pf = {f.name: f.default for f in dataclasses.fields(pt.ProxQPSettings)}
    assert list(pf) == list(jf) and pf == jf
    assert pt.ProxQPSettings().num_checks == qps.ProxQPSettings().num_checks
    invalid = [dict(max_iterations=0), dict(check_interval=0),
               dict(chunk_lanes=0), dict(first_chunk_dot_precision="bf16"),
               dict(first_chunk_dot_precision="default")]
    for kw in invalid:
        with pytest.raises(ValueError):
            qps.ProxQPSettings(**kw)
        with pytest.raises(ValueError):
            pt.ProxQPSettings(**kw)
    sf = dict(fused_chunk=True, sigma_free_rhs=True, kkt_refinement_steps=0)
    for kw in (dict(chunk_lanes=2), dict(chunk_dot_precision="high"),
               dict(first_chunk_dot_precision="default", **sf)):
        qps.ProxQPSettings(**kw)
        pt.ProxQPSettings(**kw)  # ported: accepted as in the JAX package
    for kw in (dict(anderson_memory=4), dict(record_history=True)):
        qps.ProxQPSettings(**kw)
        pt.ProxQPSettings(**kw)  # ported: accepted as in the JAX package
    # Any other chunk precision runs as "highest" in both packages (the
    # port refused it until the reduced precisions were ported).
    for kw in (dict(chunk_dot_precision="fastest", **sf),):
        qps.ProxQPSettings(**kw)  # valid for the JAX package
        st = pt.ProxQPSettings(**kw)
        assert pt_settings.chunk_precision(st, 0) == "highest"
    # The M^{-1}-form fused chunk (default refinement) is accepted and plans
    # the M^{-1} prox chunk kernel behind the sweep factor.
    minv = pt.ProxQPSettings(fused_chunk=True, require_fused=True)
    ok = device_prox_fleet(4, 128, 128, 128,
                           generator=torch.Generator().manual_seed(1))
    plan = pt.plan_proxqp(ok, minv)
    assert (plan.chunk, plan.cache, plan.factor, plan.fallback_reasons) == (
        "fused_kernel", "M_inv", "sweep_inverse", ())
    with pytest.raises(ValueError, match="refinement"):
        pt.solve_proxqp(_pair(_fleet_np())[1], pt.ProxQPSettings(
            sigma_free_rhs=True, kkt_refinement_steps=1))


def test_interop_and_device_default(monkeypatch):
    arrs = _fleet_np(seeds=(0,))
    p = proxqp_from_numpy(*arrs, device="cpu", dtype=torch.float32)
    assert p.dtype == torch.float32 and p.device.type == "cpu"
    sol = pt.solve_proxqp(p.to(torch.float64), pt.ProxQPSettings(
        max_iterations=200, eps_abs=1e-6, eps_rel=1e-6))
    out = prox_solution_to_numpy(sol)
    assert set(out) == {"x", "s", "y", "z", "converged", "iterations",
                        "res_prim", "res_dual", "rho", "status"}
    assert out["x"].shape == (1, 20)
    with pytest.raises(ValueError, match="unknown"):
        prox_settings_from_dict({"bogus": 1})
    # Host input goes to the card by default; without one that raises.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: pt.make_proxqp(*arrs),
                  lambda: proxqp_from_numpy(*arrs),
                  lambda: pt.make_qp(*arrs[:2], arrs[2], arrs[3], arrs[3])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    # A tensor keeps its device.
    t = [torch.from_numpy(a) for a in arrs]
    assert pt.make_proxqp(*t).device.type == "cpu"


def test_sparse_path_raises():
    """The matrix-free path is ported (tests/test_torch_sparse_prox.py holds
    it to JAX): warm_start_operator runs on a SparseProxQP; an object that
    is no problem still raises."""
    with pytest.raises(TypeError):
        pt.solve_proxqp(object(), pt.ProxQPSettings())
    with pytest.raises(TypeError):
        pt_proxqp.warm_start_operator(None, pt.ProxQPSettings())
    import scipy.sparse as sp

    n = 12
    prob = pt.make_sparse_proxqp(sp.identity(n, format="csr") * 2.0,
                                 np.ones(n), sp.csr_matrix(np.eye(1, n)),
                                 np.zeros(1), sp.csr_matrix(-np.eye(n)),
                                 np.zeros(n), dtype=np.float64, device="cpu")
    x, y, s, z = pt_proxqp.warm_start_operator(prob, pt.ProxQPSettings())
    assert torch.allclose(x, torch.full((n,), -1 / (2.0 + 1e-2),
                                        dtype=torch.float64))
    assert (y.shape, s.shape, z.shape) == ((1,), (n,), (n,))


def test_device_prox_fleet_family():
    g = torch.Generator().manual_seed(3)
    p = device_prox_fleet(3, 64, 8, 16, generator=g, dtype=torch.float64)
    assert (p.n, p.n_eq, p.n_ineq, p.batch_shape) == (64, 8, 16, (3,))
    assert torch.allclose(p.P, p.P.transpose(1, 2))
    assert float(torch.linalg.eigvalsh(p.P).min()) >= 1.0 - 1e-9
    # x_f is feasible with slack 1 on every inequality: recover it from b.
    box = p.to_box_qp()
    assert box.A.shape == (3, 24, 64)
    assert bool((box.l[:, :8] == box.u[:, :8]).all())
    assert bool((box.l[:, 8:] == -float("inf")).all())
    jax_box = qps.make_proxqp(*(t.numpy() for t in p.tensors())).to_box_qp()
    for a, b in zip(box.tensors(), (jax_box.P, jax_box.q, jax_box.A,
                                    jax_box.l, jax_box.u)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_exports_match_jax():
    names = ("ProxQPProblem", "make_proxqp", "pad_proxqp", "ProxQPSettings",
             "solve_proxqp", "solve_proxqp_jit", "prepare_proxqp",
             "PreparedProxFactor", "ProxQPSolution", "plan_proxqp")
    for name in names:
        assert hasattr(pt, name) and name in pt.__all__, name
        assert hasattr(qps, name) or name == "pad_proxqp", name
    assert pt.solve_proxqp_jit is pt.solve_proxqp
