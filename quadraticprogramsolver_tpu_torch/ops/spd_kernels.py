"""Batched 128x128 SPD inverse: the pivot sweep formulations
(csrc/pivot_sweep.cu), and the blocked Gauss-Jordan inverse and solve built
around the v3 sweep.

Counterpart of ``quadraticprogramsolver_tpu/ops/spd_kernels.py``
(``pallas_spd_inverse_unrolled`` with each ``variant``,
``spd_inverse_sweep_fused``, ``gj_solve_sweep``). Every formulation has a
plain PyTorch version that copies the JAX kernel's arithmetic, and a CUDA
kernel: "v3" and "value" (the same arithmetic, so one kernel), "ref", "r<q>"
and "panel".
"""

from __future__ import annotations

import collections
import math

import torch

from .. import _build
from ..core.settings import pivot_rank
from .linalg import cholesky_inverse

NB = 128
#: The panel formulation's panel width (the JAX kernel's pw).
PANEL_WIDTH = 8


def _jacobi(D: torch.Tensor):
    """(W, s_col, s_row): D scaled to unit diagonal, W = D * s_col * s_row
    with s = 1/sqrt(diag(D)) (a new tensor)."""
    s = torch.rsqrt(torch.diagonal(D, dim1=-2, dim2=-1))
    s_col, s_row = s[..., :, None], s[..., None, :]
    return D * s_col * s_row, s_col, s_row


def pivot_sweep_v3_plain(D: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch v3 sweep on (B, nb, nb): Jacobi scaling to unit
    diagonal, nb unpivoted Gauss-Jordan rank-1 steps with the folded row
    fix, unscaling. Any float dtype and device. The "value" formulation
    (``_pivot_sweep_value_kernel``) is this arithmetic element for element
    in another Mosaic layout, so it runs this too."""
    nb = D.shape[-1]
    W, s_col, s_row = _jacobi(D)  # updated in place below
    eye = torch.eye(nb, dtype=D.dtype, device=D.device)
    for j in range(nb):
        r = W[..., j:j + 1, :].clone()            # (B, 1, nb) pivot row
        dinv = 1.0 / r[..., :, j:j + 1]           # (B, 1, 1)
        a = (W[..., :, j:j + 1] - eye[:, j:j + 1]) * dinv
        W -= a * (r - eye[j:j + 1, :])
    return (2.0 * eye - W) * s_col * s_row


def pivot_sweep_ref_plain(D: torch.Tensor) -> torch.Tensor:
    """Plain "ref" sweep (``_pivot_sweep_unrolled_kernel``): no scaling; per
    step j, with the column C and row r read before it, W -= (C dinv)(r -
    e_j), then row j = r dinv and (j, j) = -dinv; the inverse is -W."""
    nb = D.shape[-1]
    W = D.clone()
    eye = torch.eye(nb, dtype=D.dtype, device=D.device)
    for j in range(nb):
        C = W[..., :, j:j + 1].clone()
        r = W[..., j:j + 1, :].clone()
        dinv = 1.0 / r[..., :, j:j + 1]
        W -= (C * dinv) * (r - eye[j:j + 1, :])
        W[..., j:j + 1, :] = r * dinv
        W[..., j, j] = -dinv[..., 0, 0]
    return -W


def pivot_sweep_rq_plain(D: torch.Tensor, q: int) -> torch.Tensor:
    """Plain rank-q sweep (``_pivot_sweep_rq_kernel``): v3's scaling and
    folded fixes, the steps taken q at a time. Step t of a group reads the
    group's pivot row and column as they stood at the group's start, less
    the earlier steps' a_u w_u (the in-group corrections, in step order);
    the group then subtracts the summed update a_0 w_0 + ... + a_{q-1}
    w_{q-1} once."""
    nb = D.shape[-1]
    W, s_col, s_row = _jacobi(D)
    eye = torch.eye(nb, dtype=D.dtype, device=D.device)
    for p in range(nb // q):
        a_list, w_list = [], []
        for t in range(q):
            j = p * q + t
            r = W[..., j:j + 1, :]
            c = W[..., :, j:j + 1]
            for a_u, w_u in zip(a_list, w_list):
                r = r - a_u[..., j:j + 1, :] * w_u
                c = c - a_u * w_u[..., :, j:j + 1]
            dinv = 1.0 / r[..., :, j:j + 1]
            a_list.append((c - eye[:, j:j + 1]) * dinv)
            w_list.append(r - eye[j:j + 1, :])
        upd = a_list[0] * w_list[0]
        for a_t, w_t in zip(a_list[1:], w_list[1:]):
            upd = upd + a_t * w_t
        W = W - upd
    return (2.0 * eye - W) * s_col * s_row


def pivot_sweep_panel_plain(D: torch.Tensor) -> torch.Tensor:
    """Plain panel sweep (``_pivot_sweep_panel_kernel``, pw = 8): v3's
    scaling and folded fixes; per panel K of 8 pivots, the factors a_t, w_t
    come from the panel slabs Wc = W[:, K] and Wr = W[K, :], updated step by
    step, and W -= V U with V = [a_0 .. a_7], U = [w_0; ..; w_7] (one
    product per panel)."""
    nb, pw = D.shape[-1], PANEL_WIDTH
    W, s_col, s_row = _jacobi(D)
    eye = torch.eye(nb, dtype=D.dtype, device=D.device)
    for p in range(nb // pw):
        K = slice(p * pw, (p + 1) * pw)
        Wc, Wr = W[..., :, K], W[..., K, :]
        a_list, w_list = [], []
        for t in range(pw):
            j = p * pw + t
            r = Wr[..., t:t + 1, :]
            dinv = 1.0 / r[..., :, j:j + 1]
            a = (Wc[..., :, t:t + 1] - eye[:, j:j + 1]) * dinv
            w = r - eye[j:j + 1, :]
            a_list.append(a)
            w_list.append(w)
            if t + 1 < pw:
                Wc = Wc - a * w[..., :, K]
                Wr = Wr - a[..., K, :] * w
        W = W - torch.matmul(torch.cat(a_list, dim=-1), torch.cat(w_list, dim=-2))
    return (2.0 * eye - W) * s_col * s_row


def pivot_sweep_plain(D: torch.Tensor, variant: str = "v3") -> torch.Tensor:
    """The plain version of ``variant``'s sweep on (B, nb, nb)."""
    q = pivot_rank(variant, D.shape[-1])
    if variant == "ref":
        return pivot_sweep_ref_plain(D)
    if variant == "panel":
        return pivot_sweep_panel_plain(D)
    if q is not None and q > 1:
        return pivot_sweep_rq_plain(D, q)
    return pivot_sweep_v3_plain(D)  # "v3", "value" and "r1"


def _pivot_sweep_cuda(D: torch.Tensor, variant: str) -> torch.Tensor:
    B = D.shape[0]
    if D.shape[1:] != (NB, NB):
        raise ValueError(f"pivot kernel takes (B, {NB}, {NB}); got {tuple(D.shape)}")
    if D.dtype != torch.float32 or D.stride(-1) != 1:
        raise ValueError("pivot kernel takes float32 with unit column stride "
                         f"(got {D.dtype}, strides {D.stride()})")
    out = torch.empty((B, NB, NB), dtype=torch.float32, device=D.device)
    _build.require_cuda_f32("spd_inverse_unrolled", out)
    q = pivot_rank(variant)
    view = (D.data_ptr(), D.stride(0), D.stride(1), out.data_ptr(), B)
    stream = _build.stream_ptr(D)
    if variant == "ref":
        entry, args = "qps_pivot_sweep_ref", (*view, stream)
    elif variant == "panel":
        entry, args = "qps_pivot_sweep_group", (*view, PANEL_WIDTH, 1, stream)
    elif q is not None and q > 1:
        entry, args = "qps_pivot_sweep_group", (*view, q, 0, stream)
    else:  # "v3", "value" and "r1": v3's arithmetic
        entry, args = "qps_pivot_sweep_v3", (*view, stream)
    _build.launch(spd_inverse_unrolled, entry, *args, variant=variant)
    return out


def spd_inverse_unrolled(D: torch.Tensor, *, variant: str = "v3") -> torch.Tensor:
    """Batched (..., 128, 128) SPD inverse by the pivot sweep ``variant``
    (Settings.pivot_variant: "v3", "ref", "value", "r<q>" with q dividing
    128, "panel"; any other string raises ValueError).

    On a CUDA tensor this launches the variant's kernel (float32; D may be a
    strided view with unit column stride, e.g. a pivot block of the factor
    slab) and counts it in ``spd_inverse_unrolled.variants[variant]``; on a
    CPU tensor it runs the variant's plain version. Like the JAX package, a
    flat batch below 4 blocks is inverted by Cholesky instead (its size
    rule, on either device, for every variant).
    """
    batch_shape, nb = D.shape[:-2], D.shape[-1]
    if D.shape[-2] != nb or nb % NB:
        raise ValueError(f"blocks must be (nb, nb) with nb % {NB} == 0; got "
                         f"{tuple(D.shape)}")
    pivot_rank(variant, nb)
    B = math.prod(batch_shape)
    D3 = D.reshape((B, nb, nb))
    if B < 4:
        return cholesky_inverse(D3).reshape(D.shape)
    if not _build.launches_kernel("spd_inverse_unrolled", D):
        return pivot_sweep_plain(D3, variant).reshape(D.shape)
    return _pivot_sweep_cuda(D3, variant).reshape(D.shape)


spd_inverse_unrolled.launches = 0
spd_inverse_unrolled.variants = collections.Counter()


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
