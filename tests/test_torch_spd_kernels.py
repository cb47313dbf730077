"""The port's v3 pivot sweep (plain version) against the JAX package's Pallas
v3 kernel in interpret mode, and against an f64 inverse."""

import numpy as np
import pytest
import torch

from quadraticprogramsolver_tpu.ops.spd_kernels import pallas_spd_inverse_unrolled

from quadraticprogramsolver_tpu_torch.ops import spd_kernels

NB = 128


def _spd_blocks(B, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, NB, NB))
    D = X @ np.swapaxes(X, 1, 2) / NB + np.eye(NB)
    # A spread of diagonal magnitudes: the Jacobi scaling's reason to exist.
    s = np.exp(rng.uniform(-2, 2, (B, NB))) * scale
    return D * s[:, :, None] * s[:, None, :]


def test_plain_v3_matches_pallas_interpret_and_f64():
    D = _spd_blocks(8, 0).astype(np.float32)
    ref = np.asarray(pallas_spd_inverse_unrolled(D, variant="v3", interpret=True))
    out = spd_kernels.spd_inverse_unrolled(torch.from_numpy(D)).numpy()
    scale = np.abs(ref).max()
    # Same arithmetic in f32; only rounding (e.g. fused multiply-add) differs.
    assert np.abs(out - ref).max() <= 1e-5 * scale, np.abs(out - ref).max() / scale
    exact = np.linalg.inv(D.astype(np.float64))
    # f32 inverse of blocks with cond ~ 1e3 after the spread diagonal.
    assert np.abs(out - exact).max() <= 1e-4 * np.abs(exact).max()


def test_plain_v3_f64_is_exact_inverse():
    D = torch.from_numpy(_spd_blocks(5, 1))
    inv = spd_kernels.pivot_sweep_v3_plain(D)
    eye = torch.eye(NB, dtype=torch.float64)
    assert float((D @ inv - eye).abs().max()) <= 1e-10


def test_small_batch_takes_cholesky_size_rule():
    D = torch.from_numpy(_spd_blocks(3, 2)).reshape(3, NB, NB)
    out = spd_kernels.spd_inverse_unrolled(D)
    np.testing.assert_allclose(out.numpy(), np.linalg.inv(D.numpy()),
                               rtol=1e-8, atol=1e-10)


def test_leading_axes_and_strided_views():
    S = torch.from_numpy(_spd_blocks(4, 3))
    wide = torch.zeros((4, NB, 3 * NB), dtype=torch.float64)
    wide[:, :, NB:2 * NB] = S
    view = wide[:, :, NB:2 * NB]          # a pivot block read through strides
    a = spd_kernels.spd_inverse_unrolled(view)
    b = spd_kernels.spd_inverse_unrolled(S.reshape(2, 2, NB, NB))
    assert torch.equal(a, b.reshape(4, NB, NB))


def test_rejects_what_it_does_not_implement():
    D = torch.from_numpy(_spd_blocks(4, 4))
    with pytest.raises(NotImplementedError):
        spd_kernels.spd_inverse_unrolled(D, variant="r2")
    with pytest.raises(ValueError):
        spd_kernels.spd_inverse_unrolled(D[:, :64, :64])
    with pytest.raises(ValueError, match="device"):
        spd_kernels.spd_inverse_unrolled(D.to("meta"))
