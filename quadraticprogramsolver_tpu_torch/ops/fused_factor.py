"""Sigma-free factor on one slab: build kernel + right-to-left level kernels.

Counterpart of ``quadraticprogramsolver_tpu/ops/fused_factor.py``. The slab
of lane b is S[b] = [A' | q | 0 | M] with M = P + sigma*I + A' diag(rho) A,
shape (n, kp + n) where kp = m + 64 (this port's layout: the q column and
zero pad round A' up to a multiple of 64 columns, not to the TPU's 128).
Block Gauss-Jordan levels run over M's 128-column blocks from the last to
the first, in place; afterwards S[b, :, :kp] = M^{-1} [A' | q | 0], so
G = S[:, :, :m] and g = S[:, :, m].

Kernels (CUDA, float32): :func:`build_slab` (csrc/slab_build.cu) and
:func:`slab_level` (csrc/slab_level.cu); the pivot blocks go through
:func:`~.spd_kernels.spd_inverse_unrolled` (csrc/pivot_sweep.cu). On CPU
tensors each wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

from .. import _build
from .spd_kernels import spd_inverse_unrolled

NB = 128
#: Column granularity of the slab's right-hand-side block [A' | q | 0].
K_ALIGN = 64


def slab_k(m: int) -> int:
    """Width of the right-hand-side block [A' | q | 0-pad] for m rows."""
    return -(-(m + 1) // K_ALIGN) * K_ALIGN


def build_slab_plain(P, A, q, rho_row, sigma: float) -> torch.Tensor:
    B, m, n = A.shape
    kp = slab_k(m)
    S = torch.zeros((B, n, kp + n), dtype=P.dtype, device=P.device)
    At = A.transpose(-1, -2)
    S[:, :, :m] = At
    S[:, :, m] = q
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    S[:, :, kp:] = P + (sigma * eye + torch.matmul(At * rho_row[:, None, :], A))
    return S


def build_slab(P, A, q, rho_row, sigma: float) -> torch.Tensor:
    """S = [A' | q | 0 | P + sigma*I + A' diag(rho) A] per lane.

    P (B, n, n), A (B, m, n), q (B, n), rho_row (B, m) -> (B, n, kp + n).
    """
    B, m, n = A.shape
    if P.device.type == "cpu":
        return build_slab_plain(P, A, q, rho_row, sigma)
    if P.device.type != "cuda":
        raise ValueError(f"no slab kernel for device {P.device}")
    if tuple(P.shape) != (B, n, n) or tuple(q.shape) != (B, n) \
            or tuple(rho_row.shape) != (B, m):
        raise ValueError("build_slab: shapes disagree "
                         f"{tuple(P.shape)}, {tuple(A.shape)}, {tuple(q.shape)}, "
                         f"{tuple(rho_row.shape)}")
    if n % 64 or m % 16 or not 0 < B <= 65535:
        raise ValueError(f"slab kernel needs n % 64 == 0, m % 16 == 0 and "
                         f"0 < B <= 65535; got n={n}, m={m}, B={B}")
    kp = slab_k(m)
    S = torch.empty((B, n, kp + n), dtype=torch.float32, device=P.device)
    _build.require_cuda_f32("build_slab", P, A, q, rho_row, S)
    code = _build.load().lib.qps_slab_build(
        P.data_ptr(), A.data_ptr(), q.data_ptr(), rho_row.data_ptr(),
        S.data_ptr(), B, n, m, kp, float(sigma), _build.stream_ptr(P))
    build_slab.launches += 1
    _build.check(code, "qps_slab_build")
    return S


build_slab.launches = 0


def slab_level_plain(S, Dinv, j: int, w_out: int) -> None:
    rows = slice(j * NB, (j + 1) * NB)
    DinvT = torch.matmul(Dinv, S[:, rows, :w_out])
    S[:, :, :w_out] -= torch.matmul(S[:, :, w_out:w_out + NB], DinvT)
    S[:, rows, :w_out] = DinvT


def slab_level(S, Dinv, j: int, w_out: int, scratch=None) -> None:
    """One Gauss-Jordan level on S[:, :, :w_out + 128], in place.

    The pivot columns are S[:, :, w_out:w_out + 128] (M's block column j),
    Dinv (B, 128, 128) the inverse of their pivot block. Pivot rows become
    Dinv . T[j rows]; the other rows get T - C . (Dinv . T[j rows]).
    ``scratch`` (CUDA only): a (B, 128, >= w_out) float32 buffer for
    Dinv . T[j rows], reused across levels; allocated when None.
    """
    if S.device.type == "cpu":
        return slab_level_plain(S, Dinv, j, w_out)
    if S.device.type != "cuda":
        raise ValueError(f"no slab kernel for device {S.device}")
    B, n, wid = S.shape
    if tuple(Dinv.shape) != (B, NB, NB):
        raise ValueError(f"Dinv must be ({B}, {NB}, {NB}); got {tuple(Dinv.shape)}")
    if n % NB or not 0 <= j < n // NB or w_out % 64 or w_out + NB > wid \
            or wid % 4 or not 0 < B <= 65535:
        raise ValueError(f"slab level: bad geometry n={n}, wid={wid}, j={j}, "
                         f"w_out={w_out}, B={B}")
    if scratch is None:
        scratch = torch.empty((B, NB, w_out), dtype=torch.float32,
                              device=S.device)
    if scratch.shape[:2] != (B, NB) or scratch.shape[2] < w_out \
            or scratch.shape[2] % 4:
        raise ValueError(f"scratch must be ({B}, {NB}, >= {w_out}); got "
                         f"{tuple(scratch.shape)}")
    _build.require_cuda_f32("slab_level", S, Dinv, scratch)
    code = _build.load().lib.qps_slab_level(
        S.data_ptr(), Dinv.data_ptr(), scratch.data_ptr(), scratch.shape[2],
        B, n, wid, j, w_out, _build.stream_ptr(S))
    slab_level.launches += 1
    _build.check(code, "qps_slab_level")


slab_level.launches = 0


def fused_factor_solve(P, A, q, rho_row, *, sigma: float) -> torch.Tensor:
    """Slab S with S[:, :, :kp] = (P + sigma*I + A' diag(rho) A)^{-1} [A' q 0].

    P (B, n, n), A (B, m, n), q (B, n), rho_row (B, m); n % 128 == 0.
    Returns the full (B, n, kp + n) slab; callers slice G = S[:, :, :m] and
    g = S[:, :, m]. Columns past kp are dead pivot state.
    """
    B, m, n = A.shape
    if n % NB:
        raise ValueError(f"n must be a multiple of {NB}; got {n}")
    kp = slab_k(m)
    S = build_slab(P, A, q, rho_row, sigma)
    scratch = None
    if S.device.type == "cuda":
        scratch = torch.empty((B, NB, kp + n - NB), dtype=S.dtype,
                              device=S.device)
    for j in range(n // NB - 1, -1, -1):
        w_out = kp + j * NB
        # The pivot block is read through the slab's strides: no copy.
        D = S[:, j * NB:(j + 1) * NB, w_out:w_out + NB]
        Dinv = spd_inverse_unrolled(D)
        slab_level(S, Dinv, j, w_out, scratch)
    return S
