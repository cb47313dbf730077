"""The port's prox chunk and two-block slab build (plain versions) against the
JAX package's Pallas kernels in interpret mode, on the same numpy inputs."""

import numpy as np
import pytest
import torch

from quadraticprogramsolver_tpu.ops.fused_factor import (
    fused_factor_solve as jax_fused_factor_solve)
from quadraticprogramsolver_tpu.ops.fused_proxqp import (
    fused_proxqp_chunk as jax_fused_proxqp_chunk)

from quadraticprogramsolver_tpu_torch.ops import fused_factor
from quadraticprogramsolver_tpu_torch.ops.fused_proxqp import (
    fused_proxqp_chunk, fused_proxqp_chunk_plain)

#: Relative limit (to max(|JAX|, 1)): both sides are FP32 with another
#: summation order over at most 256 terms.
REL = 1e-5


def _split_fleet(B, n, me, mi, seed):
    """The family of benchmarks/proxqp_fleet.py, in numpy f64."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    P = np.swapaxes(M, 1, 2) @ M / n + np.eye(n)
    A = rng.standard_normal((B, me, n))
    C = rng.standard_normal((B, mi, n))
    xf = rng.standard_normal((B, n))
    q = rng.standard_normal((B, n))
    b = np.einsum("bij,bj->bi", A, xf)
    d = np.einsum("bij,bj->bi", C, xf) + 1.0
    return P, q, A, b, C, d


def _t(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def test_plain_prox_chunk_matches_jax_interpret():
    B, n, me, mi, K = 4, 128, 128, 128, 5
    P, q, A, b, C, d = _split_fleet(B, n, me, mi, 0)
    rng = np.random.default_rng(1)
    rho = rng.uniform(0.05, 0.5, B)
    Mn = P + rho[:, None, None] * (np.swapaxes(A, 1, 2) @ A
                                   + np.swapaxes(C, 1, 2) @ C)
    X = np.linalg.solve(Mn, np.concatenate(
        [np.swapaxes(A, 1, 2), np.swapaxes(C, 1, 2), q[:, :, None]], axis=-1))
    Ga, Gc, g = X[..., :me], X[..., me:me + mi], X[..., me + mi]
    x = rng.standard_normal((B, n))
    s = np.abs(rng.standard_normal((B, mi)))
    y = rng.standard_normal((B, me))
    z = np.abs(rng.standard_normal((B, mi)))
    active = np.array([True, False, True, True])
    f32 = lambda *v: tuple(a.astype(np.float32) for a in v)  # noqa: E731
    Ga, Gc, g, A, C, b, d, x, s, y, z, rho = f32(Ga, Gc, g, A, C, b, d, x, s,
                                                 y, z, rho)
    ref = jax_fused_proxqp_chunk(
        Ga, A, C, None, None, b, d, x, s, y, z, rho, active, K=K, sigma=0.0,
        sigma_free=True, Gc=Gc, g=g, interpret=True)
    G = np.concatenate([Ga, Gc], axis=-1)
    ins = _t(G, A, C, g, b, d, x, s, y, z, rho)
    out = fused_proxqp_chunk(*ins, torch.from_numpy(active), K=K)
    plain = fused_proxqp_chunk_plain(*ins, torch.from_numpy(active), K=K)
    for name, o, p, r, v0 in zip("xsyz", out, plain, ref, (x, s, y, z)):
        r = np.asarray(r)
        assert torch.equal(o, p), name       # on the CPU the wrapper is plain
        err = np.abs(o.numpy() - r).max() / max(np.abs(r).max(), 1.0)
        assert err <= REL, (name, err)
        # The frozen lane passes through bit for bit.
        np.testing.assert_array_equal(o.numpy()[~active], v0[~active])
    assert not np.array_equal(out[0].numpy()[active], x[active])


def test_prox_chunk_wrapper_rejects_other_devices():
    B, n, me, mi = 2, 128, 128, 128
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    args = (meta(B, n, me + mi), meta(B, me, n), meta(B, mi, n), meta(B, n),
            meta(B, me), meta(B, mi), meta(B, n), meta(B, mi), meta(B, me),
            meta(B, mi), meta(B))
    with pytest.raises(ValueError, match="device"):
        fused_proxqp_chunk(*args, torch.ones(B, dtype=torch.bool,
                                             device="meta"), K=2)


def _factor_inputs(B=4, n=256, me=128, mi=128, seed=2, dtype=np.float32):
    P, q, A, _, C, _ = _split_fleet(B, n, me, mi, seed)
    rho = np.random.default_rng(seed).uniform(0.05, 0.5, (B, 1))
    rho_row = np.broadcast_to(rho, (B, me + mi)).copy()
    return tuple(v.astype(dtype) for v in (P, A, C, q, rho_row))


def test_plain_two_block_factor_matches_jax_interpret():
    P, A, C, q, rho_row = _factor_inputs()
    m = A.shape[1] + C.shape[1]
    S_j = np.asarray(jax_fused_factor_solve(
        P, (A, C), q, rho_row, sigma=0.0, at_via_dot=True, interpret=True))
    Pt, At, Ct, qt, rt = _t(P, A, C, q, rho_row)
    S_p = fused_factor.fused_factor_solve(Pt, (At, Ct), qt, rt, sigma=0.0)
    # The slabs' right-hand blocks differ in width (the port's kp is m + 64,
    # the TPU's m + 128): compare X = M^{-1}[A' C' q].
    X_j, X_p = S_j[..., :m + 1], S_p[..., :m + 1].numpy()
    err = np.abs(X_j - X_p).max() / np.abs(X_j).max()
    assert err <= REL, err


def test_two_block_slab_is_the_stacked_one_block_slab():
    P, A, C, q, rho_row = _factor_inputs(B=2, n=128, seed=3, dtype=np.float64)
    Pt, At, Ct, qt, rt = _t(P, A, C, q, rho_row)
    S1 = fused_factor.build_slab(Pt, torch.cat([At, Ct], 1), qt, rt, 0.0)
    S2 = fused_factor.build_slab(Pt, (At, Ct), qt, rt, 0.0)
    m = At.shape[1] + Ct.shape[1]
    kp = fused_factor.slab_k(m)
    assert S2.shape == S1.shape == (2, 128, kp + 128)
    assert torch.equal(S2[..., :kp], S1[..., :kp])      # [A' C' | q | 0]
    gram = S1[..., kp:]
    assert float((S2[..., kp:] - gram).abs().max()) <= 1e-12 * float(gram.abs().max())
    X1 = fused_factor.fused_factor_solve(Pt, torch.cat([At, Ct], 1), qt, rt,
                                         sigma=0.0)[..., :m + 1]
    X2 = fused_factor.fused_factor_solve(Pt, (At, Ct), qt, rt,
                                         sigma=0.0)[..., :m + 1]
    assert float((X1 - X2).abs().max()) <= 1e-10 * float(X1.abs().max())


def test_one_block_call_is_unchanged():
    """A tensor and a one-tuple give the same slab, and it is the layout of
    the box-form path: [A' | q | 0 | P + sigma*I + A' diag(rho) A]."""
    P, A, _, q, rho_row = _factor_inputs(B=2, n=128, seed=4, dtype=np.float64)
    rho_row = rho_row[:, :A.shape[1]].copy()
    Pt, At, qt, rt = _t(P, A, q, rho_row)
    S = fused_factor.build_slab(Pt, At, qt, rt, 1e-6)
    assert torch.equal(S, fused_factor.build_slab(Pt, (At,), qt, rt, 1e-6))
    m = At.shape[1]
    kp = fused_factor.slab_k(m)
    assert torch.equal(S[..., :m], At.transpose(1, 2))
    assert torch.equal(S[..., m], qt)
    assert not S[..., m + 1:kp].any()
    Mn = Pt + (1e-6 * torch.eye(128, dtype=Pt.dtype)
               + torch.matmul(At.transpose(1, 2) * rt[:, None, :], At))
    assert torch.equal(S[..., kp:], Mn)
    with pytest.raises(ValueError, match="rho_row"):
        fused_factor.fused_factor_solve(Pt, (At, At), qt, rt, sigma=0.0)
