"""The port's sigma-free ADMM chunk (plain version) against the JAX package's
fused_admm_chunk(sigma_free=True) in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.models import kkt as jax_kkt
from quadraticprogramsolver_tpu.ops.fused_admm import fused_admm_chunk as jax_chunk

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.models import admm as pt_admm
from quadraticprogramsolver_tpu_torch.models import kkt as pt_kkt
from quadraticprogramsolver_tpu_torch.ops.fused_admm import (
    fused_admm_chunk, fused_admm_chunk_plain)
from quadraticprogramsolver_tpu_torch.utils.interop import qp_from_numpy

B, N, M, K = 4, 128, 128, 5
ST = dict(rho=0.1, check_interval=K, kkt_refinement_steps=0,
          sigma_free_rhs=True, sigma=1e-7)


def _case(seed=1):
    qp = qps.pad_qp(qps.generate_batch(qps.ProblemClass.RANDOM_QP, batch=B,
                                       num_elements=100, seed=0,
                                       dtype=np.float32), N, M)
    st = qps.Settings(**ST)
    rho = jnp.full((B,), st.rho, jnp.float32)
    cache = jax_kkt.cholesky_init(qp, rho, jnp.float32(st.sigma), st)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N)).astype(np.float32)
    z = rng.standard_normal((B, M)).astype(np.float32)
    y = rng.standard_normal((B, M)).astype(np.float32)
    rho_row = np.full((B, M), st.rho, np.float32)
    active = np.array([True, False, True, True])
    return qp, cache, x, z, y, rho_row, active


def test_plain_chunk_matches_jax_interpret():
    qp, cache, x, z, y, rho_row, active = _case()
    ref = jax_chunk(cache["G"], qp.A, None, None, qp.l, qp.u, x, z, y,
                    rho_row, active, K=K, alpha=1.6, sigma=1e-7,
                    sigma_free=True, g=cache["g"], interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = fused_admm_chunk(t(cache["G"]), t(qp.A), t(cache["g"]), t(qp.l),
                           t(qp.u), t(x), t(z), t(y), t(rho_row), t(active),
                           K=K, alpha=1.6)
    names = ("x", "z", "y", "x_prev", "z_prev", "Ax", "ATy")
    for name, r, o in zip(names, ref, out):
        r, o = np.asarray(r), o.numpy()
        scale = np.abs(r).max() + 1.0
        assert np.abs(r - o).max() / scale <= 1e-5, (name, np.abs(r - o).max())
    # The inactive lane passes through, with prev = current.
    for o, v in ((out[0], x), (out[3], x), (out[1], z), (out[4], z), (out[2], y)):
        assert np.array_equal(o[1].numpy(), v[1])


def test_fused_and_torch_chunks_agree_in_the_solver():
    """The port's _run_chunk: the fused branch (plain kernel on CPU) and the
    masked torch loop give the same iterates (f64, so to rounding)."""
    qp_j, cache, x, z, y, _, active = _case(2)
    qp = qp_from_numpy(qp_j.P, qp_j.q, qp_j.A, qp_j.l, qp_j.u, device="cpu")
    kw = dict(max_iterations=100, kkt_backend=pt.KKTBackendKind.CHOLESKY, **ST)
    fused = pt.Settings(fused_chunk=True, **kw)
    plain = pt.Settings(**kw)
    assert pt_admm._fused_chunk_ok(qp, fused)
    assert not pt_admm._fused_chunk_ok(qp, plain)
    backend = pt_kkt.get_backend(plain.kkt_backend, qp)
    state = pt_admm._init_state(qp, plain, backend, torch.from_numpy(x).double(),
                                torch.from_numpy(z).double(),
                                torch.from_numpy(y).double())
    state.status = torch.where(torch.from_numpy(active), 0, 3).int()
    a = pt_admm._run_chunk(qp, fused, backend, state)
    b = pt_admm._run_chunk(qp, plain, backend, state)
    for u, v in zip(a[:5], b[:5]):
        assert float((u - v).abs().max()) <= 1e-12 * (float(v.abs().max()) + 1)
    Ax, ATy = a[6]
    assert float((Ax - qp.matvec_A(a[0])).abs().max()) <= 1e-12 * float(Ax.abs().max())
    assert float((ATy - qp.matvec_At(a[2])).abs().max()) <= 1e-12 * float(ATy.abs().max())


def test_chunk_plain_is_dtype_generic_and_wrapper_checks_device():
    qp_j, cache, x, z, y, rho_row, active = _case(3)
    args = [torch.from_numpy(np.array(v)).double() for v in
            (cache["G"], qp_j.A, cache["g"], qp_j.l, qp_j.u, x, z, y, rho_row)]
    out = fused_admm_chunk_plain(*args, torch.from_numpy(active), K=2, alpha=1.6)
    assert all(o.dtype == torch.float64 for o in out)
    with pytest.raises(ValueError, match="device"):
        fused_admm_chunk(*(a.to("meta") for a in args),
                         torch.from_numpy(active).to("meta"), K=2, alpha=1.6)
