"""Sigma-free factor on one slab: build kernel + right-to-left level kernels.

Counterpart of ``quadraticprogramsolver_tpu/ops/fused_factor.py``. The slab
of lane b is S[b] = [A' | q | 0 | M] with M = P + sigma*I + A' diag(rho) A,
shape (n, kp + n) where kp = m + 64 (this port's layout: the q column and
zero pad round A' up to a multiple of 64 columns, not to the TPU's 128).
A may be a tuple of row blocks (A_0, A_1, ...), the prox-ALM family's (A, C)
pair: the slab is then [A_0' | A_1' | ... | q | 0 | P + sigma*I +
sum_i A_i' diag(rho_i) A_i], with rho in block order, and the blocks'
concatenation is never materialized.
Block Gauss-Jordan levels run over M's 128-column blocks from the last to
the first, in place; afterwards S[b, :, :kp] = M^{-1} [A' | q | 0], so
G = S[:, :, :m] and g = S[:, :, m].

Kernels (CUDA, float32): :func:`build_slab` (csrc/slab_build.cu, one or two
blocks) and :func:`slab_level` (csrc/slab_level.cu, FP32 or bf16x3
products); the pivot blocks go through
:func:`~.spd_kernels.spd_inverse_unrolled` (csrc/pivot_sweep.cu, any pivot
formulation). On CPU tensors each wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import collections

import torch

from .. import _build
from .linalg import bf16_split, resolve_precision
from .spd_kernels import spd_inverse_unrolled

NB = 128
#: Column granularity of the slab's right-hand-side block [A' | q | 0].
K_ALIGN = 64


def slab_k(m: int) -> int:
    """Width of the right-hand-side block [A' | q | 0-pad] for m rows."""
    return -(-(m + 1) // K_ALIGN) * K_ALIGN


def _blocks(A) -> tuple:
    return tuple(A) if isinstance(A, (tuple, list)) else (A,)


def build_slab_plain(P, A, q, rho_row, sigma: float) -> torch.Tensor:
    blocks = _blocks(A)
    B, n = q.shape
    m = sum(a.shape[-2] for a in blocks)
    kp = slab_k(m)
    S = torch.zeros((B, n, kp + n), dtype=P.dtype, device=P.device)
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    gram = sigma * eye
    off = 0
    for a in blocks:
        mb = a.shape[-2]
        At = a.transpose(-1, -2)
        S[:, :, off:off + mb] = At
        gram = gram + torch.matmul(At * rho_row[:, None, off:off + mb], a)
        off += mb
    S[:, :, m] = q
    S[:, :, kp:] = P + gram
    return S


def build_slab(P, A, q, rho_row, sigma: float) -> torch.Tensor:
    """S = [A_0' | A_1' | q | 0 | P + sigma*I + sum_i A_i' diag(rho_i) A_i]
    per lane.

    P (B, n, n), A (B, m, n) or a tuple of row blocks (B, m_i, n) (at most
    two on the card), q (B, n), rho_row (B, sum m_i) -> (B, n, kp + n).
    """
    blocks = _blocks(A)
    if not _build.launches_kernel("build_slab", P):
        return build_slab_plain(P, blocks, q, rho_row, sigma)
    if not 1 <= len(blocks) <= 2:
        raise ValueError(f"slab kernel takes one or two row blocks; got "
                         f"{len(blocks)}")
    B, n = q.shape
    ms = [a.shape[-2] for a in blocks]
    m = sum(ms)
    if tuple(P.shape) != (B, n, n) or tuple(rho_row.shape) != (B, m) \
            or any(tuple(a.shape) != (B, mb, n) for a, mb in zip(blocks, ms)):
        raise ValueError("build_slab: shapes disagree "
                         f"{tuple(P.shape)}, {[tuple(a.shape) for a in blocks]}, "
                         f"{tuple(q.shape)}, {tuple(rho_row.shape)}")
    if n % 64 or any(mb % 16 or mb == 0 for mb in ms) or not 0 < B <= 65535:
        raise ValueError(f"slab kernel needs n % 64 == 0, every block's rows "
                         f"a nonzero multiple of 16 and 0 < B <= 65535; got "
                         f"n={n}, rows={ms}, B={B}")
    kp = slab_k(m)
    S = torch.empty((B, n, kp + n), dtype=torch.float32, device=P.device)
    _build.require_cuda_f32("build_slab", P, *blocks, q, rho_row, S)
    A1, m1 = (blocks[1].data_ptr(), ms[1]) if len(blocks) == 2 else (None, 0)
    _build.launch(
        build_slab, "qps_slab_build",
        P.data_ptr(), blocks[0].data_ptr(), A1, q.data_ptr(), rho_row.data_ptr(),
        S.data_ptr(), B, n, ms[0], m1, kp, float(sigma), _build.stream_ptr(P))
    return S


build_slab.launches = 0


#: The slab level's product precisions, in the order of their codes in
#: qps_slab_level: FP32, and bf16x3 (csrc/common.cuh: Prec).
LEVEL_PRECISIONS = ("highest", "high")


def _dot3(a, b):
    """a @ b in bf16x3 as the JAX level kernel writes it: (ah bh + ah bl) +
    al bh, each a product of bf16 halves summed in a's dtype (lo lo
    dropped)."""
    ah, al = (h.to(a.dtype) for h in bf16_split(a))
    bh, bl = (h.to(b.dtype) for h in bf16_split(b))
    return torch.matmul(ah, bh) + torch.matmul(ah, bl) + torch.matmul(al, bh)


def slab_level_plain(S, Dinv, j: int, w_out: int,
                     dot_precision: str = "highest") -> None:
    rows = slice(j * NB, (j + 1) * NB)
    mm = _dot3 if resolve_precision(dot_precision, S.dtype) == "high" else torch.matmul
    DinvT = mm(Dinv, S[:, rows, :w_out])
    S[:, :, :w_out] -= mm(S[:, :, w_out:w_out + NB], DinvT)
    S[:, rows, :w_out] = DinvT


def slab_level(S, Dinv, j: int, w_out: int, scratch=None,
               dot_precision: str = "highest") -> None:
    """One Gauss-Jordan level on S[:, :, :w_out + 128], in place.

    The pivot columns are S[:, :, w_out:w_out + 128] (M's block column j),
    Dinv (B, 128, 128) the inverse of their pivot block. Pivot rows become
    Dinv . T[j rows]; the other rows get T - C . (Dinv . T[j rows]).
    ``dot_precision``: "highest" (FP32 products) or "high" (bf16x3: Dinv,
    the pivot rows, C and Dinv . T split into bf16 halves, lo . lo
    dropped; the level's other operand, T, enters elementwise); float64
    runs "highest". ``scratch`` (CUDA only): a (B, 128, >= w_out) float32
    buffer for Dinv . T[j rows], reused across levels; allocated when None.
    A launch counts in ``slab_level.variants[dot_precision]``.
    """
    if dot_precision not in LEVEL_PRECISIONS:
        raise ValueError(f"slab level precision must be one of "
                         f"{LEVEL_PRECISIONS}; got {dot_precision!r}")
    if not _build.launches_kernel("slab_level", S):
        return slab_level_plain(S, Dinv, j, w_out, dot_precision)
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
    _build.launch(
        slab_level, "qps_slab_level",
        S.data_ptr(), Dinv.data_ptr(), scratch.data_ptr(), scratch.shape[2],
        B, n, wid, j, w_out, LEVEL_PRECISIONS.index(dot_precision),
        _build.stream_ptr(S), variant=dot_precision)


slab_level.launches = 0
slab_level.variants = collections.Counter()


def fused_factor_solve(P, A, q, rho_row, *, sigma: float,
                       pivot_variant: str = "v3",
                       dot_precision: str = "highest") -> torch.Tensor:
    """Slab S with S[:, :, :kp] = (P + sigma*I + A' diag(rho) A)^{-1} [A' q 0].

    P (B, n, n), A (B, m, n) or a tuple of row blocks, q (B, n), rho_row
    (B, m) with m the blocks' total rows; n % 128 == 0. ``pivot_variant``
    picks the pivot sweep (:func:`~.spd_kernels.spd_inverse_unrolled`),
    ``dot_precision`` the levels' products ("highest" or "high"); the build
    and the pivot inverses are FP32 under every setting, as in the JAX
    package. Returns the full (B, n, kp + n) slab; callers slice G = S[:, :,
    :m] and g = S[:, :, m]. Columns past kp are dead pivot state.
    """
    B, n = q.shape
    m = rho_row.shape[-1]
    if n % NB:
        raise ValueError(f"n must be a multiple of {NB}; got {n}")
    if m != sum(a.shape[-2] for a in _blocks(A)):
        raise ValueError(f"rho_row has {m} rows; the blocks have "
                         f"{[a.shape[-2] for a in _blocks(A)]}")
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
        Dinv = spd_inverse_unrolled(D, variant=pivot_variant)
        slab_level(S, Dinv, j, w_out, scratch, dot_precision)
    return S
