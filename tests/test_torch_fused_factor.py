"""The port's slab factor (plain versions of the build, pivot and level
kernels) against the JAX package's fused_factor_solve in interpret mode."""

import numpy as np
import pytest
import torch

from quadraticprogramsolver_tpu.ops.fused_factor import (
    fused_factor_solve as jax_fused_factor_solve)

from quadraticprogramsolver_tpu_torch.ops import fused_factor

B, N, M = 4, 256, 128     # two 128-blocks, so two levels run
SIGMA = 1e-6


def _inputs(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((B, N, N)) * (rng.random((B, N, N)) < 0.15)
    P = np.swapaxes(Mm, 1, 2) @ Mm + 1e-2 * np.eye(N)
    A = rng.standard_normal((B, M, N)) * (rng.random((B, M, N)) < 0.15)
    q = rng.standard_normal((B, N))
    rho = rng.uniform(0.1, 2.0, (B, M))
    return tuple(v.astype(dtype) for v in (P, A, q, rho))


def _torch(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def test_plain_factor_matches_jax_interpret():
    P, A, q, rho = _inputs()
    S_j = np.asarray(jax_fused_factor_solve(P, A, q, rho, sigma=SIGMA,
                                            interpret=True))
    S_p = fused_factor.fused_factor_solve(*_torch(P, A, q, rho), sigma=SIGMA)
    G_j, g_j = S_j[..., :M], S_j[..., M]
    G_p, g_p = S_p[..., :M].numpy(), S_p[..., M].numpy()
    for name, a, b in (("G", G_j, G_p), ("g", g_j, g_p)):
        scale = np.abs(a).max()
        assert np.abs(a - b).max() <= 1e-5 * scale, (name, np.abs(a - b).max(), scale)


def test_plain_factor_f64_solves_normal_system():
    P, A, q, rho = _inputs(1, np.float64)
    S = fused_factor.fused_factor_solve(*_torch(P, A, q, rho), sigma=SIGMA)
    Mn = P + SIGMA * np.eye(N) + np.swapaxes(A, 1, 2) @ (rho[:, :, None] * A)
    R = np.concatenate([np.swapaxes(A, 1, 2), q[:, :, None]], axis=-1)
    X = np.linalg.solve(Mn, R)
    got = S[..., : M + 1].numpy()
    assert np.abs(got - X).max() <= 1e-9 * np.abs(X).max()


def test_build_slab_layout():
    P, A, q, rho = _torch(*_inputs(2, np.float64))
    S = fused_factor.build_slab(P, A, q, rho, SIGMA)
    kp = fused_factor.slab_k(M)
    assert kp == M + 64 and S.shape == (B, N, kp + N)
    assert torch.equal(S[:, :, :M], A.transpose(1, 2))
    assert torch.equal(S[:, :, M], q)
    assert not S[:, :, M + 1:kp].any()
    Mn = P + SIGMA * torch.eye(N, dtype=P.dtype) + A.transpose(1, 2) @ (rho[:, :, None] * A)
    assert float((S[:, :, kp:] - Mn).abs().max()) <= 1e-12 * float(Mn.abs().max())


def test_slab_level_touches_only_the_live_region():
    P, A, q, rho = _torch(*_inputs(3, np.float64))
    S = fused_factor.build_slab(P, A, q, rho, SIGMA)
    kp = fused_factor.slab_k(M)
    j = N // 128 - 1
    w_out = kp + j * 128
    Dinv = torch.linalg.inv(S[:, j * 128:, w_out:])
    before = S.clone()
    fused_factor.slab_level(S, Dinv, j, w_out)
    assert torch.equal(S[:, :, w_out:], before[:, :, w_out:])
    # Pivot rows hold Dinv . T[j rows]; the pivot block's image is the identity.
    piv = S[:, j * 128:, :w_out]
    ref = Dinv @ before[:, j * 128:, :w_out]
    assert float((piv - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_slab_wrappers_reject_other_devices():
    P, A, q, rho = _torch(*_inputs(4))
    with pytest.raises(ValueError, match="device"):
        fused_factor.build_slab(P.to("meta"), A.to("meta"), q.to("meta"),
                                rho.to("meta"), SIGMA)
    with pytest.raises(ValueError):
        fused_factor.fused_factor_solve(P[:, :100, :100], A[:, :, :100],
                                        q[:, :100], rho, sigma=SIGMA)
