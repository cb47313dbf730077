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
blocks; at n % 128 == 0 one launch over the gram's upper triangle) and
:func:`slab_level` (csrc/slab_level.cu: one launch a level over column
strips on the tensor cores, bf16x6 at "highest", held to FP32's accuracy,
and bf16x3 at "high"), each picking its kernel by a pure rule
(:func:`build_kernel`,
:func:`level_kernel`); the pivot blocks go through
:func:`~.spd_kernels.spd_inverse_unrolled` (csrc/pivot_sweep.cu, any pivot
formulation). The previous kernels stay as the witnesses
:func:`build_slab_prev` and :func:`slab_level_prev` (the two-launch level,
at either precision; no solver calls them). On CPU tensors each wrapper
runs its plain PyTorch version.
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


def build_kernel(n: int) -> str:
    """The kernel :func:`build_slab` launches for n columns: "triangle"
    (csrc/slab_build.cu: slab_build_kernel, one launch over the gram's upper
    triangle of 128 x 128 tiles, the lower one its mirror) when n % 128 ==
    0, else "square" (the previous kernels, :func:`build_slab_prev`'s: the
    full gram in 64 x 64 tiles, then [A' | q | 0] in a second launch)."""
    return "triangle" if n % NB == 0 else "square"


_BUILD_ENTRIES = {"triangle": "qps_slab_build", "square": "qps_slab_build_prev"}


def _launch_build(wrapper, kernel, P, blocks, q, rho_row, sigma, variant=None):
    """Check the build's operands and launch ``kernel`` ("triangle" or
    "square"), counted on ``wrapper`` (and ``wrapper.variants[variant]``);
    returns the slab."""
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
    _build.require_cuda_f32(wrapper.__name__, P, *blocks, q, rho_row, S)
    A1, m1 = (blocks[1].data_ptr(), ms[1]) if len(blocks) == 2 else (None, 0)
    _build.launch(
        wrapper, _BUILD_ENTRIES[kernel],
        P.data_ptr(), blocks[0].data_ptr(), A1, q.data_ptr(), rho_row.data_ptr(),
        S.data_ptr(), B, n, ms[0], m1, kp, float(sigma), _build.stream_ptr(P),
        variant=variant)
    return S


def build_slab(P, A, q, rho_row, sigma: float) -> torch.Tensor:
    """S = [A_0' | A_1' | q | 0 | P + sigma*I + sum_i A_i' diag(rho_i) A_i]
    per lane.

    P (B, n, n), A (B, m, n) or a tuple of row blocks (B, m_i, n) (at most
    two on the card), q (B, n), rho_row (B, sum m_i) -> (B, n, kp + n). On a
    CUDA tensor it launches the kernel :func:`build_kernel` names for n,
    counted in ``build_slab.variants`` under that name. The triangle
    kernel's gram part is exactly symmetric: its lower triangle mirrors the
    upper one, which with [A' | q | 0] is bit for bit the square kernels'.
    """
    blocks = _blocks(A)
    if not _build.launches_kernel("build_slab", P):
        return build_slab_plain(P, blocks, q, rho_row, sigma)
    kernel = build_kernel(q.shape[-1])
    return _launch_build(build_slab, kernel, P, blocks, q, rho_row, sigma,
                         variant=kernel)


build_slab.launches = 0
build_slab.variants = collections.Counter()


def build_slab_prev(P, A, q, rho_row, sigma: float) -> torch.Tensor:
    """:func:`build_slab` through the previous kernels (the "square" build)
    at every n % 64 == 0: the witness and timing baseline of the triangle
    kernel on the card (no solver calls it). On a CUDA tensor it launches
    them and counts in ``build_slab_prev.launches``; on a CPU tensor it runs
    :func:`build_slab_plain`."""
    blocks = _blocks(A)
    if not _build.launches_kernel("build_slab_prev", P):
        return build_slab_plain(P, blocks, q, rho_row, sigma)
    return _launch_build(build_slab_prev, "square", P, blocks, q, rho_row,
                         sigma)


build_slab_prev.launches = 0


#: The slab level's product precisions, in the order of their codes in
#: qps_slab_level: FP32, and bf16x3 (csrc/common.cuh: Prec).
LEVEL_PRECISIONS = ("highest", "high")


def bf16_split3(t):
    """The three bfloat16 pieces of t: hi = bf16(t), mid = bf16(t - hi), lo
    = bf16(t - hi - mid), each rounded to nearest even (csrc/slab_level.cu:
    split3). Both subtractions are exact in float32, and hi + mid + lo == t
    for a float32 t that is 0 or has 2^-110 <= |t| < 2^128 - 2^120 (lo not
    below bfloat16's least subnormal, hi finite)."""
    hi = t.to(torch.bfloat16)
    r = t - hi.to(t.dtype)
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.to(t.dtype)).to(torch.bfloat16)


def _dot3(a, b):
    """a @ b in bf16x3 as the JAX level kernel writes it: (ah bh + ah bl) +
    al bh, each a product of bf16 halves summed in a's dtype (lo lo
    dropped)."""
    ah, al = (h.to(a.dtype) for h in bf16_split(a))
    bh, bl = (h.to(b.dtype) for h in bf16_split(b))
    return torch.matmul(ah, bh) + torch.matmul(ah, bl) + torch.matmul(al, bh)


def _dot6(a, b):
    """a @ b in bf16x6 as the "highest" strip kernel computes it: each
    operand as its three bf16 pieces (:func:`bf16_split3`); for each 16-deep
    chunk of k the products lo hi, mid mid, hi lo, mid hi, hi mid and hi hi
    of its pieces summed in that order in a's dtype, and the chunks' sums
    added in k order (mid lo, lo mid and lo lo, below 2^-23 of the product,
    dropped). The kernel sums each chunk's products on the tensor cores,
    which round toward zero, and adds the chunks' sums with von Neumann
    rounding to undo that drift; here every sum rounds to nearest. So the
    two agree to FP32 rounding, not bit for bit. k % 16 == 0."""
    ah, am, al = (p.to(a.dtype) for p in bf16_split3(a))
    bh, bm, bl = (p.to(b.dtype) for p in bf16_split3(b))
    out = None
    for k in range(0, a.shape[-1], 16):
        ks = slice(k, k + 16)
        chunk = None
        for x, y in ((al, bh), (am, bm), (ah, bl), (am, bh), (ah, bm), (ah, bh)):
            term = torch.matmul(x[..., ks], y[..., ks, :])
            chunk = term if chunk is None else chunk + term
        out = chunk if out is None else out + chunk
    return out


def slab_level_plain(S, Dinv, j: int, w_out: int,
                     dot_precision: str = "highest") -> None:
    rows = slice(j * NB, (j + 1) * NB)
    mm = _dot3 if resolve_precision(dot_precision, S.dtype) == "high" else torch.matmul
    DinvT = mm(Dinv, S[:, rows, :w_out])
    S[:, :, :w_out] -= mm(S[:, :, w_out:w_out + NB], DinvT)
    S[:, rows, :w_out] = DinvT


def level_kernel(dot_precision: str) -> str:
    """The kernel :func:`slab_level` launches at ``dot_precision``, one
    launch a level over column strips on the tensor cores, no scratch:
    "strip_x6" at "highest" (csrc/slab_level.cu: level_strip_kernel_x6,
    bf16x6 wgmma), "strip" at "high" (level_strip_kernel_high, bf16x3
    mma.sync). The two-launch "tiles" level, DinvT through a scratch
    buffer, is :func:`slab_level_prev`'s alone."""
    if dot_precision not in LEVEL_PRECISIONS:
        raise ValueError(f"slab level precision must be one of "
                         f"{LEVEL_PRECISIONS}; got {dot_precision!r}")
    return "strip_x6" if dot_precision == "highest" else "strip"


def _check_level(S, Dinv, j: int, w_out: int):
    B, n, wid = S.shape
    if tuple(Dinv.shape) != (B, NB, NB):
        raise ValueError(f"Dinv must be ({B}, {NB}, {NB}); got {tuple(Dinv.shape)}")
    if n % NB or not 0 <= j < n // NB or w_out % 64 or w_out + NB > wid \
            or wid % 4 or not 0 < B <= 65535:
        raise ValueError(f"slab level: bad geometry n={n}, wid={wid}, j={j}, "
                         f"w_out={w_out}, B={B}")
    return B, n, wid


def slab_level(S, Dinv, j: int, w_out: int,
               dot_precision: str = "highest") -> None:
    """One Gauss-Jordan level on S[:, :, :w_out + 128], in place.

    The pivot columns are S[:, :, w_out:w_out + 128] (M's block column j),
    Dinv (B, 128, 128) the inverse of their pivot block. Pivot rows become
    Dinv . T[j rows]; the other rows get T - C . (Dinv . T[j rows]).
    ``dot_precision``: "highest" (FP32 products: the plain version's
    torch.matmul; on the card bf16x6, the products' operands split into
    three bf16 pieces, held to the FP32 level's error, see :func:`_dot6`)
    or "high" (bf16x3: Dinv, the pivot rows, C and Dinv . T split into bf16
    halves, lo . lo dropped; the level's other operand, T, enters
    elementwise); float64 runs "highest". On a CUDA tensor it launches the
    strip kernel of that precision (:func:`level_kernel`), counted in
    ``slab_level.variants[dot_precision]``; it needs no scratch.
    """
    level_kernel(dot_precision)  # checks the precision
    if not _build.launches_kernel("slab_level", S):
        return slab_level_plain(S, Dinv, j, w_out, dot_precision)
    B, n, wid = _check_level(S, Dinv, j, w_out)
    _build.require_cuda_f32("slab_level", S, Dinv)
    _build.launch(
        slab_level, "qps_slab_level_strip",
        S.data_ptr(), Dinv.data_ptr(), B, n, wid, j, w_out,
        LEVEL_PRECISIONS.index(dot_precision), _build.stream_ptr(S),
        variant=dot_precision)


slab_level.launches = 0
slab_level.variants = collections.Counter()


def slab_level_prev(S, Dinv, j: int, w_out: int, scratch=None,
                    dot_precision: str = "highest") -> None:
    """:func:`slab_level` through the previous kernel of ``dot_precision``
    (the two launches, DinvT through ``scratch``, a (B, 128, >= w_out)
    float32 buffer allocated when None): the witness and timing baseline of
    the strip kernels on the card (no solver calls it); at "highest" its
    sequential FP32 sums are the error the bf16x6 strip kernel is held to.
    On a CUDA tensor (float32) it launches it and counts in
    ``slab_level_prev.launches``; on a CPU tensor (float32 or float64) it
    runs :func:`slab_level_plain`. Other dtypes raise."""
    level_kernel(dot_precision)  # checks the precision
    if not _build.launches_witness("slab_level_prev", S, Dinv):
        return slab_level_plain(S, Dinv, j, w_out, dot_precision)
    B, n, wid = _check_level(S, Dinv, j, w_out)
    if scratch is None:
        scratch = torch.empty((B, NB, w_out), dtype=torch.float32,
                              device=S.device)
    if scratch.shape[:2] != (B, NB) or scratch.shape[2] < w_out \
            or scratch.shape[2] % 4:
        raise ValueError(f"scratch must be ({B}, {NB}, >= {w_out}); got "
                         f"{tuple(scratch.shape)}")
    _build.require_cuda_f32("slab_level_prev", S, Dinv, scratch)
    _build.launch(
        slab_level_prev, "qps_slab_level",
        S.data_ptr(), Dinv.data_ptr(), scratch.data_ptr(), scratch.shape[2],
        B, n, wid, j, w_out, LEVEL_PRECISIONS.index(dot_precision),
        _build.stream_ptr(S))


slab_level_prev.launches = 0


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
    n = q.shape[-1]
    m = rho_row.shape[-1]
    if n % NB:
        raise ValueError(f"n must be a multiple of {NB}; got {n}")
    if m != sum(a.shape[-2] for a in _blocks(A)):
        raise ValueError(f"rho_row has {m} rows; the blocks have "
                         f"{[a.shape[-2] for a in _blocks(A)]}")
    kp = slab_k(m)
    S = build_slab(P, A, q, rho_row, sigma)
    for j in range(n // NB - 1, -1, -1):
        w_out = kp + j * NB
        # The pivot block is read through the slab's strides: no copy.
        D = S[:, j * NB:(j + 1) * NB, w_out:w_out + NB]
        Dinv = spd_inverse_unrolled(D, variant=pivot_variant)
        slab_level(S, Dinv, j, w_out, dot_precision)
    return S
