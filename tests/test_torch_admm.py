"""The port's whole solve (the slice) against the JAX package's.

f64: the port's solve with the fused knobs (auto-padded; the plain versions
of the four kernels on the CPU) against JAX solve_jit sigma-free unfused —
identical statuses and iteration counts, x and y to 1e-7. f32: against the
JAX fused path in interpret mode. Plus the auto-pad, infeasibility and
require_fused contracts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.problems.generator import ProblemClass

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
    device_random_qp_fleet)
from quadraticprogramsolver_tpu_torch.utils.interop import (
    qp_from_numpy, settings_from_dict)

F64_CASES = [
    # (class, seed): all lanes of these batches reach status 3 in both modes.
    (ProblemClass.RANDOM_QP, 0),
    (ProblemClass.PORTFOLIO, 3),
]


def _np(qp):
    return tuple(np.asarray(v) for v in (qp.P, qp.q, qp.A, qp.l, qp.u))


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "static"])
@pytest.mark.parametrize("cls,seed", F64_CASES, ids=lambda v: getattr(v, "value", v))
def test_f64_fused_solve_matches_jax(cls, seed, adaptive):
    qp_j = qps.generate_batch(cls, batch=4, num_elements=100, seed=seed,
                              dtype=np.float64)
    st_j = qps.Settings(max_iterations=4000, eps_abs=1e-6, eps_rel=1e-6,
                        rho=0.1, adaptive_rho=adaptive, kkt_refinement_steps=0,
                        sigma_free_rhs=True)
    ref = qps.solve_jit(qp_j, st_j)
    st_p = settings_from_dict({**dataclasses.asdict(st_j), "fused_factor": True,
                               "fused_chunk": True, "require_fused": True})
    qp = qp_from_numpy(*_np(qp_j), device="cpu")
    p = pt.plan(qp, st_p)
    assert (p.chunk, p.factor, p.padded) == ("fused_kernel", "fused_slab", (128, 128))
    sol = pt.solve(qp, st_p)
    np.testing.assert_array_equal(sol.info.status.numpy(), np.asarray(ref.info.status))
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    assert (sol.info.status.numpy() == 3).all()
    for name in ("x", "y", "z"):
        a, b = getattr(sol, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-7, (name, np.abs(a - b).max())
    np.testing.assert_allclose(sol.info.objective.numpy(),
                               np.asarray(ref.info.objective), rtol=1e-9)
    # rho comes from ratios of residuals that are themselves differences of
    # O(1) terms near convergence, so it carries their relative rounding.
    np.testing.assert_allclose(sol.info.rho.numpy(), np.asarray(ref.info.rho),
                               rtol=1e-6)


@pytest.mark.parametrize("rho_eq_scale", [1.0, 10.0])
def test_f64_unfused_m_inverse_form_matches_jax(rho_eq_scale):
    """The torch chunk with the M^{-1} cache and one refinement step, with
    scalar rho and with equality rows weighted (row_weights)."""
    data = qps.generate_random_qp(ProblemClass.RANDOM_QP, 30, seed=4)
    assert (data.l == data.u).any()
    st_j = qps.Settings(rho=0.1, eps_abs=1e-7, eps_rel=1e-7,
                        rho_eq_scale=rho_eq_scale)
    ref = qps.solve_jit(qps.make_qp(*data.dense()), st_j)
    sol = pt.solve(pt.make_qp(*data.dense(), device="cpu"),
                   settings_from_dict(dataclasses.asdict(st_j)))
    assert int(sol.info.status) == int(ref.info.status) >= 2
    assert int(sol.info.iterations) == int(ref.info.iterations)
    assert np.abs(sol.x.numpy() - np.asarray(ref.x)).max() <= 1e-7


def test_infeasible_instance_is_certified():
    data = qps.generate_random_qp(ProblemClass.EQUALITY_QP, 20, seed=13)
    st_j = qps.Settings(rho=0.1, eps_abs=1e-6, eps_rel=1e-6)
    ref = qps.solve_jit(qps.make_qp(*data.dense()), st_j)
    sol = pt.solve(pt.make_qp(*data.dense(), device="cpu"),
                   settings_from_dict(dataclasses.asdict(st_j)))
    assert int(ref.info.status) == pt.Status.PRIMAL_INFEASIBLE
    assert int(sol.info.status) == pt.Status.PRIMAL_INFEASIBLE
    assert int(sol.info.iterations) == int(ref.info.iterations)


def test_f32_fused_solve_matches_jax_interpret():
    qp_j = qps.pad_qp(qps.generate_batch(ProblemClass.RANDOM_QP, batch=4,
                                         num_elements=100, seed=0,
                                         dtype=np.float32), 128, 128)
    st_j = qps.Settings(rho=0.1, eps_abs=1e-5, eps_rel=1e-5,
                        max_iterations=2000, kkt_refinement_steps=0,
                        sigma_free_rhs=True, sigma=1e-7, fused_factor=True,
                        fused_chunk=True)
    ref = qps.solve_jit(qp_j, st_j)
    qp = qp_from_numpy(*_np(qp_j), dtype=torch.float32, device="cpu")
    sol = pt.solve(qp, settings_from_dict(dataclasses.asdict(st_j)))
    np.testing.assert_array_equal(sol.info.status.numpy(), np.asarray(ref.info.status))
    assert (sol.info.status.numpy() >= 2).all()
    assert np.abs(sol.x.numpy() - np.asarray(ref.x)).max() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_auto_pad_equals_pre_padded(dtype):
    g = torch.Generator().manual_seed(7)
    qp = device_random_qp_fleet(8, 100, 50, generator=g, dtype=dtype)
    st = pt.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4, rho=0.4,
                     check_interval=11, kkt_refinement_steps=0,
                     sigma_free_rhs=True, fused_factor=True, fused_chunk=True,
                     require_fused=True)
    assert pt.plan(qp, st).padded == (128, 128)
    a = pt.solve(qp, st)
    b = pt.solve(pt.pad_qp(qp, 128, 128), st)
    assert a.x.shape == (8, 100) and a.y.shape == (8, 50)
    assert torch.equal(a.info.status, b.info.status)
    assert torch.equal(a.info.iterations, b.info.iterations)
    assert torch.equal(a.x, b.x[:, :100]) and torch.equal(a.y, b.y[:, :50])
    assert not b.x[:, 100:].any() and not b.y[:, 50:].any()  # inert padding
    assert (a.info.status >= 2).all()


def test_require_fused_raises_on_every_failed_gate():
    g = torch.Generator().manual_seed(8)
    base = dict(kkt_refinement_steps=0, sigma_free_rhs=True, fused_factor=True,
                fused_chunk=True, require_fused=True)
    st = pt.Settings(**base)
    small = device_random_qp_fleet(2, 128, 128, generator=g)
    with pytest.raises(ValueError, match="B=2 < 4"):
        pt.solve(small, st)
    wide = device_random_qp_fleet(4, 128, 20, generator=g)   # 6.4x inflation
    with pytest.raises(ValueError, match="auto-pad"):
        pt.solve(wide, st)
    p = pt.plan(device_random_qp_fleet(4, 128, 128, generator=g).to("meta"), st)
    assert any("device" in r for r in p.fallback_reasons)
    single = pt.make_qp(*(t[0] for t in small.tensors()))
    with pytest.raises(ValueError, match="one batch axis"):
        pt.solve(single, st)
    # Without require_fused the same fleet solves on the torch path.
    ok = pt.solve(single, dataclasses.replace(st, require_fused=False))
    assert ok.x.shape == (128,)
