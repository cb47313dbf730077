"""The port's blocked-Schur SPD inverse and the small helpers of
ops/linalg.py and core/state.py against the JAX package's, on SPD inputs
made from a numpy seed; and the rule that spd_inverse's dispatch does not
take the Schur recursion."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraticprogramsolver_tpu.core import state as jax_state
from quadraticprogramsolver_tpu.ops import linalg as jax_linalg

from quadraticprogramsolver_tpu_torch.core.state import Status, all_done
from quadraticprogramsolver_tpu_torch.ops import linalg

SIZES = (32, 64, 96, 128, 200, 256)
#: Limits relative to max|M^-1|.
TOL = {np.float64: 1e-10, np.float32: 1e-4}


def _spd(batch, n, seed):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal(batch + (n, n))
    return np.einsum("...ij,...kj->...ik", W, W) + n * 0.01 * np.eye(n)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", SIZES)
def test_spd_inverse_blocked_matches_jax_and_numpy(n, dtype):
    M = _spd((3,), n, seed=n).astype(dtype)
    got = linalg.spd_inverse_blocked(torch.from_numpy(M))
    assert got.dtype == torch.from_numpy(M).dtype and got.shape == M.shape
    got = got.numpy()
    ref_jax = np.asarray(jax_linalg.spd_inverse_blocked(jnp.asarray(M)))
    exact = np.linalg.inv(M.astype(np.float64))
    scale = np.abs(exact).max()
    assert np.abs(got - ref_jax).max() / scale <= TOL[dtype]
    assert np.abs(got - exact).max() / scale <= TOL[dtype]
    # Symmetrized at the end, as JAX's.
    assert np.array_equal(got, np.swapaxes(got, -1, -2))


def test_spd_inverse_blocked_recursion_and_base():
    """The same cut-off as JAX's (Cholesky at n <= 64 or odd n), an
    unbatched matrix, and two batch axes."""
    assert linalg._SPD_BASE_N == jax_linalg._SPD_BASE_N == 64
    for shape in ((), (2, 2)):
        M = _spd(shape, 130, seed=5)
        got = linalg.spd_inverse_blocked(torch.from_numpy(M)).numpy()
        ref = np.asarray(jax_linalg.spd_inverse_blocked(jnp.asarray(M)))
        assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-10
    M = _spd((2,), 67, seed=6)   # odd: straight to Cholesky
    chol = linalg._spd_inverse_cholesky(torch.from_numpy(M)).numpy()
    assert np.array_equal(linalg.spd_inverse_blocked(torch.from_numpy(M)).numpy(),
                          chol)
    ref = np.asarray(jax_linalg._spd_inverse_cholesky(jnp.asarray(M)))
    assert np.abs(chol - ref).max() / np.abs(ref).max() <= 1e-10


def test_spd_inverse_blocked_follows_the_product_scope(monkeypatch):
    """The four products a level go through ``mm`` at the enclosing scope's
    precision ("highest" outside any), with torch's float32 products at
    "highest" inside whatever the caller set, and the caller's setting
    back after."""
    seen = []
    mm = linalg.mm

    def spy(a, b, precision=None):
        seen.append((linalg.current_precision(),
                     torch.get_float32_matmul_precision()))
        return mm(a, b, precision)

    monkeypatch.setattr(linalg, "mm", spy)
    M32 = torch.from_numpy(_spd((2,), 256, seed=3).astype(np.float32))
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        highest = linalg.spd_inverse_blocked(M32)
        assert torch.get_float32_matmul_precision() == "high"
        # Two levels above the base: 4 products at 256, 4 at each 128.
        assert seen == [("highest", "highest")] * 12
        seen.clear()
        with linalg.products("default"):
            reduced = linalg.spd_inverse_blocked(M32)
        assert seen == [("default", "highest")] * 12
    finally:
        torch.set_float32_matmul_precision(before)
    assert not torch.equal(highest, reduced)
    M64 = M32.double()
    with linalg.products("default"):
        assert torch.equal(linalg.spd_inverse_blocked(M64),
                           linalg.spd_inverse_blocked(M64))


@pytest.mark.parametrize("n,batch", [(200, 3), (256, 4), (128, 2), (256, 3)])
def test_spd_inverse_dispatch_does_not_take_the_recursion(monkeypatch, n,
                                                          batch):
    """spd_inverse keeps its dispatch: the sweep where sweep_ok holds,
    Cholesky elsewhere; never the Schur recursion."""
    def refuse(*a, **k):
        raise AssertionError("spd_inverse reached spd_inverse_blocked")

    monkeypatch.setattr(linalg, "spd_inverse_blocked", refuse)
    monkeypatch.setattr(linalg, "_spd_inverse_blocked_raw", refuse)
    M = torch.from_numpy(_spd((batch,), n, seed=n + batch))
    got = linalg.spd_inverse(M)
    if not linalg.sweep_ok(n, batch, M.dtype, M.device):
        assert torch.equal(got, linalg.cholesky_inverse(M))
    exact = np.linalg.inv(M.numpy())
    assert np.abs(got.numpy() - exact).max() / np.abs(exact).max() <= 1e-9


def test_inf_norm_diff_matches_jax():
    rng = np.random.default_rng(0)
    for shape in ((5,), (3, 7), (2, 3, 0)):
        a, b = rng.standard_normal(shape), rng.standard_normal(shape)
        got = linalg.inf_norm_diff(torch.from_numpy(a), torch.from_numpy(b))
        ref = np.asarray(jax_linalg.inf_norm_diff(jnp.asarray(a), jnp.asarray(b)))
        assert got.shape == ref.shape
        assert np.array_equal(got.numpy(), ref)


def test_batch_identity_matches_jax(monkeypatch):
    for shape, n, dtype in (((), 4, np.float64), ((3,), 5, np.float32),
                            ((2, 3), 2, np.float64)):
        ref = np.asarray(jax_linalg.batch_identity(shape, n, dtype))
        dt = torch.from_numpy(np.zeros(0, dtype)).dtype
        got = linalg.batch_identity(shape, n, dt, device="cpu")
        assert got.device.type == "cpu"
        assert np.array_equal(got.numpy(), ref)
        assert got.numpy().dtype == ref.dtype
    # The device is the caller's tensor's; by default the card.
    M = torch.zeros(2, 3, 3)
    assert linalg.batch_identity(M.shape[:-2], 3, M.dtype, M.device).device == M.device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        linalg.batch_identity((2,), 3, torch.float32)


@pytest.mark.parametrize("status", [
    [0, 0], [1, 2, 3], [2, 0, 3], [3], [4, 5, 2], [[1, 0], [2, 3]],
    [[2, 3], [4, 5]]])
def test_all_done_matches_jax(status):
    s = np.asarray(status, np.int32)
    got = all_done(torch.from_numpy(s))
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == bool(jax_state.all_done(jnp.asarray(s)))
    assert int(Status.RUNNING) == int(jax_state.Status.RUNNING)
