"""The port's blocked Gauss-Jordan inverse and solve (the sweep around the
pivot kernel) against the JAX package's, and ops/linalg.py's dispatch rule
between the sweep and Cholesky."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraticprogramsolver_tpu.ops import linalg as jax_linalg
from quadraticprogramsolver_tpu.ops import spd_kernels as jax_spd

from quadraticprogramsolver_tpu_torch.ops import linalg, spd_kernels


def _spd(B, n, seed, dtype=np.float64):
    """Normal-matrix-like SPD blocks (P + sigma I + A'A shape of spectrum)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, n, n))
    return (np.swapaxes(X, 1, 2) @ X / n + 0.1 * np.eye(n)).astype(dtype)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_f32_sweep_and_solve_match_jax_interpret_pivot():
    """f32: the port's sweeps (plain v3 pivot on the CPU) against JAX's with
    its Pallas v3 pivot kernel in interpret mode, on the same numpy input."""
    M = _spd(4, 256, 0, np.float32)
    R = np.random.default_rng(1).standard_normal((4, 256, 129)).astype(np.float32)
    piv = functools.partial(jax_spd.pallas_spd_inverse_unrolled, interpret=True)
    inv_j = np.asarray(jax_spd.spd_inverse_sweep_fused(jnp.asarray(M),
                                                       pivot_inverse=piv))
    X_j = np.asarray(jax_spd.gj_solve_sweep(jnp.asarray(M), jnp.asarray(R),
                                            pivot_inverse=piv))
    inv_p = spd_kernels.spd_inverse_sweep_fused(torch.from_numpy(M)).numpy()
    X_p = spd_kernels.gj_solve_sweep(torch.from_numpy(M),
                                     torch.from_numpy(R)).numpy()
    # Same f32 arithmetic in another order (cond(M) ~ 1e2): a few ulps.
    assert _rel(inv_p, inv_j) <= 1e-5, _rel(inv_p, inv_j)
    assert _rel(X_p, X_j) <= 1e-5, _rel(X_p, X_j)
    assert inv_p.dtype == X_p.dtype == np.float32


@pytest.mark.parametrize("batch", [(5,), (2, 3)], ids=["flat", "two_axes"])
def test_f64_sweep_and_solve_match_jax(batch):
    """f64: JAX's sweeps with its f64 inverse as the pivot (as
    tests/test_linalg.py runs them) against the port's with the plain v3
    pivot, to 1e-12."""
    B = int(np.prod(batch))
    M = _spd(B, 256, 2).reshape(batch + (256, 256))
    R = np.random.default_rng(3).standard_normal(batch + (256, 40))
    inv_j = np.asarray(jax_spd.spd_inverse_sweep_fused(
        jnp.asarray(M), pivot_inverse=jax_linalg.spd_inverse))
    X_j = np.asarray(jax_spd.gj_solve_sweep(
        jnp.asarray(M), jnp.asarray(R), pivot_inverse=jax_linalg.spd_inverse))
    inv_p = spd_kernels.spd_inverse_sweep_fused(torch.from_numpy(M)).numpy()
    X_p = spd_kernels.gj_solve_sweep(torch.from_numpy(M),
                                     torch.from_numpy(R)).numpy()
    assert inv_p.shape == M.shape and X_p.shape == R.shape
    assert _rel(inv_p, inv_j) <= 1e-12, _rel(inv_p, inv_j)
    assert _rel(X_p, X_j) <= 1e-12, _rel(X_p, X_j)
    assert _rel(inv_p, np.linalg.inv(M)) <= 1e-12


DISPATCH = [
    # (batch, n, dtype, takes the sweep)
    ((4,), 256, torch.float32, True),
    ((4,), 128, torch.float64, True),     # f64 on the CPU: the plain pivot
    ((2, 2), 128, torch.float32, True),   # flat batch 4
    ((3,), 256, torch.float32, False),    # flat batch < 4
    ((4,), 200, torch.float32, False),    # n not a multiple of 128
    ((), 128, torch.float64, False),      # one matrix
]


@pytest.mark.parametrize("batch,n,dtype,sweep", DISPATCH,
                         ids=[f"{b}-{n}-{str(d)[6:]}" for b, n, d, _ in DISPATCH])
def test_dispatch_between_sweep_and_cholesky(monkeypatch, batch, n, dtype, sweep):
    calls = {"pivot": 0, "cholesky": 0}
    pivot, chol = spd_kernels.spd_inverse_unrolled, torch.linalg.cholesky

    def counted_pivot(D, **kw):
        calls["pivot"] += 1
        return pivot(D, **kw)

    def counted_cholesky(M, *a, **kw):
        calls["cholesky"] += 1
        return chol(M, *a, **kw)

    monkeypatch.setattr(spd_kernels, "spd_inverse_unrolled", counted_pivot)
    monkeypatch.setattr(torch.linalg, "cholesky", counted_cholesky)
    B = int(np.prod(batch))
    M = torch.from_numpy(_spd(B, n, 4).reshape(batch + (n, n))).to(dtype)
    R = torch.ones(batch + (n, 3), dtype=dtype)
    inv = linalg.spd_inverse(M)
    X = linalg.spd_solve(M, R)
    levels = n // 128
    assert calls == ({"pivot": 2 * levels, "cholesky": 0} if sweep
                     else {"pivot": 0, "cholesky": 2})
    ref = torch.linalg.inv(M.double())
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    assert float((inv.double() - ref).abs().max() / ref.abs().max()) <= tol
    assert float((X.double() - ref @ R.double()).abs().max()
                 / (ref @ R.double()).abs().max()) <= tol
    assert linalg.sweep_ok(n, B, dtype, "cpu") is sweep


def test_rule_is_static_on_cuda_dtype():
    """On the card only float32 takes the sweep (the kernels' type); the
    rule reads the device without needing one."""
    assert linalg.sweep_ok(512, 2048, torch.float32, "cuda")
    assert not linalg.sweep_ok(512, 2048, torch.float64, "cuda")
    with pytest.raises(ValueError):
        spd_kernels.spd_inverse_sweep_fused(torch.eye(200).expand(4, 200, 200))
