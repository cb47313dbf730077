"""Batched 128x128 SPD inverse: the v3 pivot sweep (csrc/pivot_sweep.cu), and
the blocked Gauss-Jordan inverse and solve built around it.

Counterpart of ``quadraticprogramsolver_tpu/ops/spd_kernels.py``
(``pallas_spd_inverse_unrolled(variant="v3")``, ``spd_inverse_sweep_fused``,
``gj_solve_sweep``). Only the v3 pivot variant is ported; the others are
queued in ROADMAP.md.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .linalg import cholesky_inverse

NB = 128


def pivot_sweep_v3_plain(D: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch v3 sweep on (B, nb, nb): Jacobi scaling to unit
    diagonal, nb unpivoted Gauss-Jordan rank-1 steps with the folded row
    fix, unscaling. Any float dtype and device."""
    nb = D.shape[-1]
    s = torch.rsqrt(torch.diagonal(D, dim1=-2, dim2=-1))
    s_col, s_row = s[..., :, None], s[..., None, :]
    W = D * s_col * s_row  # new tensor; updated in place below
    eye = torch.eye(nb, dtype=D.dtype, device=D.device)
    for j in range(nb):
        r = W[..., j:j + 1, :].clone()            # (B, 1, nb) pivot row
        dinv = 1.0 / r[..., :, j:j + 1]           # (B, 1, 1)
        a = (W[..., :, j:j + 1] - eye[:, j:j + 1]) * dinv
        W -= a * (r - eye[j:j + 1, :])
    return (2.0 * eye - W) * s_col * s_row


def _pivot_sweep_v3_cuda(D: torch.Tensor) -> torch.Tensor:
    B = D.shape[0]
    if D.shape[1:] != (NB, NB):
        raise ValueError(f"pivot kernel takes (B, {NB}, {NB}); got {tuple(D.shape)}")
    if D.dtype != torch.float32 or D.stride(-1) != 1:
        raise ValueError("pivot kernel takes float32 with unit column stride "
                         f"(got {D.dtype}, strides {D.stride()})")
    out = torch.empty((B, NB, NB), dtype=torch.float32, device=D.device)
    _build.require_cuda_f32("spd_inverse_unrolled", out)
    _build.launch(spd_inverse_unrolled, "qps_pivot_sweep_v3", D.data_ptr(),
                  D.stride(0), D.stride(1), out.data_ptr(), B,
                  _build.stream_ptr(D))
    return out


def spd_inverse_unrolled(D: torch.Tensor, *, variant: str = "v3") -> torch.Tensor:
    """Batched (..., 128, 128) SPD inverse by the v3 pivot sweep.

    On a CUDA tensor this launches the kernel (float32; D may be a strided
    view with unit column stride, e.g. a pivot block of the factor slab);
    on a CPU tensor it runs :func:`pivot_sweep_v3_plain`. Like the JAX
    package, a flat batch below 4 blocks is inverted by Cholesky instead
    (its size rule, on either device).
    """
    if variant != "v3":
        raise NotImplementedError(f"pivot variant {variant!r} is not ported")
    batch_shape, nb = D.shape[:-2], D.shape[-1]
    if D.shape[-2] != nb or nb % NB:
        raise ValueError(f"blocks must be (nb, nb) with nb % {NB} == 0; got "
                         f"{tuple(D.shape)}")
    B = math.prod(batch_shape)
    D3 = D.reshape((B, nb, nb))
    if B < 4:
        return cholesky_inverse(D3).reshape(D.shape)
    if not _build.launches_kernel("spd_inverse_unrolled", D):
        return pivot_sweep_v3_plain(D3).reshape(D.shape)
    return _pivot_sweep_v3_cuda(D3).reshape(D.shape)


spd_inverse_unrolled.launches = 0


def _check_sweep_shape(M: torch.Tensor) -> int:
    n = M.shape[-1]
    if M.shape[-2] != n or n % NB or n == 0:
        raise ValueError(f"the sweep takes (..., n, n) with n a nonzero "
                         f"multiple of {NB}; got {tuple(M.shape)}")
    return n


def spd_inverse_sweep_fused(M: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse by the flat blocked Gauss-Jordan sweep.

    One level per 128-block k of a working copy W of M: Dinv = the pivot
    inverse of W's diagonal block (:func:`spd_inverse_unrolled`, read through
    a strided view), the rank-128 update W -= (C Dinv) R of every entry
    (C, R: the block column and row before the level), then the block
    column, row and diagonal become C Dinv, Dinv R and -Dinv; the inverse
    is -W. Symmetric only to rounding, as in the JAX package. M is
    (..., n, n) with n % 128 == 0; W is updated in place.
    """
    n = _check_sweep_shape(M)
    W = M.reshape(-1, n, n).clone(memory_format=torch.contiguous_format)
    for k in range(n // NB):
        s = slice(k * NB, (k + 1) * NB)
        Dinv = spd_inverse_unrolled(W[:, s, s])
        R = W[:, s, :].clone()
        CDinv = torch.bmm(W[:, :, s], Dinv)
        DinvR = torch.bmm(Dinv, R)
        W.baddbmm_(CDinv, R, alpha=-1.0)
        W[:, :, s] = CDinv
        W[:, s, :] = DinvR
        W[:, s, s] = -Dinv
    return W.neg_().reshape(M.shape)


def gj_solve_sweep(M: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Batched M^{-1} R by blocked Gauss-Jordan, without forming M^{-1}.

    M (..., n, n) SPD with n % 128 == 0, R (..., n, k) with any k. Level j
    inverts the pivot block of the not yet eliminated columns, then updates
    the right-hand side and only the trailing pivot columns (in place, in a
    working copy of M): rows of block j take Dinv times their old values,
    every other row subtracts C times those (C: block column j).
    """
    n = _check_sweep_shape(M)
    W = M.reshape(-1, n, n).clone(memory_format=torch.contiguous_format)
    Y = R.reshape(-1, n, R.shape[-1]).clone(memory_format=torch.contiguous_format)
    for j in range(n // NB):
        s = slice(j * NB, (j + 1) * NB)
        Dinv = spd_inverse_unrolled(W[:, s, s])
        C = W[:, :, s]
        DinvY = torch.bmm(Dinv, Y[:, s, :])
        Y.baddbmm_(C, DinvY, alpha=-1.0)
        Y[:, s, :] = DinvY
        if (j + 1) * NB < n:
            T = W[:, :, (j + 1) * NB:]   # the trailing pivot columns
            DinvT = torch.bmm(Dinv, T[:, s, :])
            T.baddbmm_(C, DinvT, alpha=-1.0)
            T[:, s, :] = DinvT
    return Y.reshape(R.shape)
