"""Batched SPD inverses: the pivot sweep formulations (csrc/pivot_sweep.cu,
csrc/pivot_variants.cu), the blocked Gauss-Jordan inverse and solve built
around the v3 sweep, and the package's other SPD-inverse entry points: the
round-1 unscaled sweep and the flat sweep around it (csrc/pivot_sweep_2d.cu),
the paired-64 sweep and the 2x2 block Schur inverse built on it
(csrc/pivot_sweep_v3p.cu), and the fused normal-matrix inverse
(csrc/normal_inverse.cu).

Counterpart of ``quadraticprogramsolver_tpu/ops/spd_kernels.py``
(``pallas_spd_inverse_unrolled`` with each ``variant``,
``spd_inverse_sweep_fused``, ``gj_solve_sweep``, ``pallas_spd_inverse_nb``,
``spd_inverse_sweep``, ``pallas_spd_inverse_64p``, ``spd_inverse_128_schur``,
``pallas_normal_inverse``). Every formulation has a plain PyTorch version
that copies the JAX kernel's arithmetic, and a CUDA kernel: "v3" and "value"
(the same arithmetic, so one kernel; the port's first v3 kernel stays beside
it as its bit-for-bit witness, :func:`pivot_sweep_v3_prev`), "ref", "r<q>"
and "panel" (one group kernel, :func:`group_kernel`), the round-1 sweep, the
paired-64 sweep and the normal-matrix inverse. The first kernels of "ref",
"r<q>" and "panel", the round-1 sweep, the paired-64 sweep and the
normal-matrix inverse stay beside theirs as witnesses in the same way
(:func:`pivot_sweep_ref_prev`, :func:`pivot_sweep_group_prev`,
:func:`pivot_sweep_2d_prev`, :func:`pivot_sweep_v3p_prev`,
:func:`normal_inverse_prev`). The two sweeps
the solvers call (``spd_inverse_sweep_fused``, ``gj_solve_sweep``) run their
torch products at the caller's precision scope (:func:`~.linalg.products`,
"highest" outside one); the entry points no solver calls
(``spd_inverse_sweep``, ``spd_inverse_128_schur``, ``normal_inverse_plain``)
run theirs in full FP32 (:func:`~.linalg.fp32_products`). TF32 is off in
every one.
"""

from __future__ import annotations

import collections
import math

import torch

from .. import _build
from ..core.settings import pivot_rank
from .linalg import cholesky_inverse, fp32_products, mm, products, sub_mm_

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


def _blocks_cuda(wrapper, entry: str, D: torch.Tensor, *extra,
                 variant: str | None = None) -> torch.Tensor:
    """Launch a per-block sweep kernel on (B, nb, nb) float32 blocks read
    through strides (unit column stride: a pivot block of a larger matrix
    needs no copy); the output is a contiguous (B, nb, nb) tensor."""
    B, nb = D.shape[0], D.shape[-1]
    if D.dtype != torch.float32 or D.stride(-1) != 1:
        raise ValueError(f"{wrapper.__name__}: the kernel takes float32 with "
                         f"unit column stride (got {D.dtype}, strides "
                         f"{D.stride()})")
    out = torch.empty((B, nb, nb), dtype=torch.float32, device=D.device)
    _build.require_cuda_f32(wrapper.__name__, out)
    _build.launch(wrapper, entry, D.data_ptr(), D.stride(0), D.stride(1),
                  out.data_ptr(), B, *extra, _build.stream_ptr(D),
                  variant=variant)
    return out


#: The group kernels' entry points by :func:`group_kernel`'s name.
_GROUP_ENTRIES = {"warp": "qps_pivot_sweep_group",
                  "block": "qps_pivot_sweep_group_prev"}


def _group_args(variant: str):
    """(q, panel) of a group formulation ("r<q>" with q >= 2, or "panel");
    None for any other variant."""
    if variant == "panel":
        return PANEL_WIDTH, 1
    q = pivot_rank(variant)
    return (q, 0) if q is not None and q > 1 else None


def group_kernel(variant: str) -> str:
    """The kernel a group formulation ("r<q>" with q >= 2, or "panel")
    launches on the card: "warp" (csrc/pivot_variants.cu:
    group_sweep_kernel, v3's register layout, one barrier a group) where a
    group's q pivots lie in one warp's 16 rows, q in {2, 4, 8, 16} and the
    panel (q = 8); "block" (the first port, pivot_sweep_group_kernel, one
    512-thread CTA a block, three or four barriers a group) for q in {32,
    64, 128}, whose groups span warps. Any other variant raises."""
    args = _group_args(variant)
    if args is None:
        raise ValueError(f"{variant!r} is not a group formulation ('r<q>' "
                         f"with q >= 2, or 'panel')")
    return "warp" if args[0] <= 16 else "block"


def _pivot_sweep_cuda(D: torch.Tensor, variant: str) -> torch.Tensor:
    if D.shape[1:] != (NB, NB):
        raise ValueError(f"pivot kernel takes (B, {NB}, {NB}); got {tuple(D.shape)}")
    group = _group_args(variant)
    if variant == "ref":
        entry, extra = "qps_pivot_sweep_ref", ()
    elif group is not None:
        entry, extra = _GROUP_ENTRIES[group_kernel(variant)], group
    else:  # "v3", "value" and "r1": v3's arithmetic
        entry, extra = "qps_pivot_sweep_v3", ()
    return _blocks_cuda(spd_inverse_unrolled, entry, D, *extra, variant=variant)


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
    if B < 4:  # contiguous, as the kernels return and the level kernels take
        return cholesky_inverse(D3).contiguous().reshape(D.shape)
    if not _build.launches_kernel("spd_inverse_unrolled", D):
        return pivot_sweep_plain(D3, variant).reshape(D.shape)
    return _pivot_sweep_cuda(D3, variant).reshape(D.shape)


spd_inverse_unrolled.launches = 0
spd_inverse_unrolled.variants = collections.Counter()


def pivot_sweep_v3_prev(D: torch.Tensor) -> torch.Tensor:
    """v3's sweep on (B, 128, 128) blocks through the port's first v3
    kernel (csrc/pivot_sweep.cu: pivot_sweep_v3_prev_kernel), which the
    solver's kernel must equal bit for bit: the witness and timing baseline
    of :func:`spd_inverse_unrolled`'s "v3" on the card (no solver calls it).
    On a CUDA tensor (float32, unit column stride, any B >= 1) it launches
    that kernel and counts it in ``pivot_sweep_v3_prev.launches``; on a CPU
    tensor it runs :func:`pivot_sweep_v3_plain`."""
    if D.ndim != 3 or D.shape[1:] != (NB, NB):
        raise ValueError(f"blocks must be ({NB}, {NB}); got {tuple(D.shape)}")
    if not _build.launches_kernel("pivot_sweep_v3_prev", D):
        return pivot_sweep_v3_plain(D)
    return _blocks_cuda(pivot_sweep_v3_prev, "qps_pivot_sweep_v3_prev", D)


pivot_sweep_v3_prev.launches = 0


def _witness_blocks(wrapper, D: torch.Tensor) -> bool:
    """``_build.launches_witness`` for the witness sweeps' (B, 128, 128)
    blocks."""
    if D.ndim != 3 or D.shape[1:] != (NB, NB):
        raise ValueError(f"blocks must be ({NB}, {NB}); got {tuple(D.shape)}")
    return _build.launches_witness(wrapper.__name__, D)


def pivot_sweep_2d_prev(D: torch.Tensor) -> torch.Tensor:
    """The round-1 sweep on (B, 128, 128) blocks through the port's first
    kernel of it (csrc/sweep_block.cuh: sweep_block_prev_kernel<GUARD>),
    which :func:`spd_inverse_nb`'s kernel must equal bit for bit: its witness
    and timing baseline (no entry point calls it). On a CUDA tensor
    (float32, unit column stride, any B >= 1) it launches that kernel and
    counts it in ``pivot_sweep_2d_prev.launches``; on a CPU tensor it runs
    :func:`sweep_inverse_block_plain` with ``guard_zero``."""
    if not _witness_blocks(pivot_sweep_2d_prev, D):
        return sweep_inverse_block_plain(D, guard_zero=True)
    return _blocks_cuda(pivot_sweep_2d_prev, "qps_pivot_sweep_2d_prev", D)


pivot_sweep_2d_prev.launches = 0


def pivot_sweep_ref_prev(D: torch.Tensor) -> torch.Tensor:
    """The "ref" sweep on (B, 128, 128) blocks through the port's first
    kernel of it (csrc/sweep_block.cuh: sweep_block_prev_kernel<FOLD>), which
    :func:`spd_inverse_unrolled`'s "ref" kernel must equal bit for bit: its
    witness and timing baseline (no solver calls it). On a CUDA tensor
    (float32, unit column stride, any B >= 1) it launches that kernel and
    counts it in ``pivot_sweep_ref_prev.launches``; on a CPU tensor it runs
    :func:`pivot_sweep_ref_plain`."""
    if not _witness_blocks(pivot_sweep_ref_prev, D):
        return pivot_sweep_ref_plain(D)
    return _blocks_cuda(pivot_sweep_ref_prev, "qps_pivot_sweep_ref_prev", D)


pivot_sweep_ref_prev.launches = 0


def pivot_sweep_group_prev(D: torch.Tensor, variant: str) -> torch.Tensor:
    """The group formulation ``variant`` ("r<q>" with q >= 2 dividing 128,
    or "panel") on (B, 128, 128) blocks through the port's first kernel of
    it (csrc/pivot_variants.cu: pivot_sweep_group_kernel), which
    :func:`spd_inverse_unrolled`'s "warp" kernel must equal bit for bit: its
    witness and timing baseline (no solver calls it for q <= 16; it is
    itself the "block" kernel of q >= 32, :func:`group_kernel`). On a CUDA
    tensor (float32, unit column stride, any B >= 1) it launches that kernel
    and counts it in ``pivot_sweep_group_prev.launches``; on a CPU tensor it
    runs :func:`pivot_sweep_plain`. Any other variant raises."""
    group_kernel(variant)  # checks the variant
    if not _witness_blocks(pivot_sweep_group_prev, D):
        return pivot_sweep_plain(D, variant)
    return _blocks_cuda(pivot_sweep_group_prev, "qps_pivot_sweep_group_prev",
                        D, *_group_args(variant))


pivot_sweep_group_prev.launches = 0


def _check_sweep_shape(M: torch.Tensor) -> int:
    n = M.shape[-1]
    if M.shape[-2] != n or n % NB or n == 0:
        raise ValueError(f"the sweep takes (..., n, n) with n a nonzero "
                         f"multiple of {NB}; got {tuple(M.shape)}")
    return n


@products()
def spd_inverse_sweep_fused(M: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse by the flat blocked Gauss-Jordan sweep.

    One level per 128-block k of a working copy W of M: Dinv = the pivot
    inverse of W's diagonal block (:func:`spd_inverse_unrolled`, read through
    a strided view), the rank-128 update W -= (C Dinv) R of every entry
    (C, R: the block column and row before the level), then the block
    column, row and diagonal become C Dinv, Dinv R and -Dinv; the inverse
    is -W. Symmetric only to rounding, as in the JAX package. M is
    (..., n, n) with n % 128 == 0; W is updated in place. The products
    around the pivot kernel run at the caller's scope (the factor's
    precision, ops/linalg.py: products), as JAX's einsums follow it; the
    pivot inverses stay FP32.
    """
    n = _check_sweep_shape(M)
    W = M.reshape(-1, n, n).clone(memory_format=torch.contiguous_format)
    for k in range(n // NB):
        s = slice(k * NB, (k + 1) * NB)
        Dinv = spd_inverse_unrolled(W[:, s, s])
        R = W[:, s, :].clone()
        CDinv = mm(W[:, :, s], Dinv)
        DinvR = mm(Dinv, R)
        sub_mm_(W, CDinv, R)
        W[:, :, s] = CDinv
        W[:, s, :] = DinvR
        W[:, s, s] = -Dinv
    return W.neg_().reshape(M.shape)


@products()
def gj_solve_sweep(M: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Batched M^{-1} R by blocked Gauss-Jordan, without forming M^{-1}.

    M (..., n, n) SPD with n % 128 == 0, R (..., n, k) with any k. Level j
    inverts the pivot block of the not yet eliminated columns, then updates
    the right-hand side and only the trailing pivot columns (in place, in a
    working copy of M): rows of block j take Dinv times their old values,
    every other row subtracts C times those (C: block column j). The
    products follow the caller's scope, as :func:`spd_inverse_sweep_fused`'s.
    """
    n = _check_sweep_shape(M)
    W = M.reshape(-1, n, n).clone(memory_format=torch.contiguous_format)
    Y = R.reshape(-1, n, R.shape[-1]).clone(memory_format=torch.contiguous_format)
    for j in range(n // NB):
        s = slice(j * NB, (j + 1) * NB)
        Dinv = spd_inverse_unrolled(W[:, s, s])
        C = W[:, :, s]
        DinvY = mm(Dinv, Y[:, s, :])
        sub_mm_(Y, C, DinvY)
        Y[:, s, :] = DinvY
        if (j + 1) * NB < n:
            T = W[:, :, (j + 1) * NB:]   # the trailing pivot columns
            DinvT = mm(Dinv, T[:, s, :])
            sub_mm_(T, C, DinvT)
            T[:, s, :] = DinvT
    return Y.reshape(R.shape)


# ----------------------------------------- the package's other entry points


def _check_lanes(lanes) -> None:
    """``lanes`` is the TPU kernels' blocks per grid step, a Mosaic layout
    knob: checked (a positive int), and no result depends on it here."""
    if isinstance(lanes, bool) or not isinstance(lanes, int) or lanes < 1:
        raise ValueError(f"lanes must be a positive int; got {lanes!r}")


def sweep_inverse_block_plain(D: torch.Tensor, guard_zero: bool = False) -> torch.Tensor:
    """Plain unscaled scalar sweep on (B, nb, nb): ``_sweep_inverse_block``
    (the JAX package's spd_kernels.py:54-81, the normal-matrix kernel's pivot
    inverse) or, with ``guard_zero``, the round-1 kernel
    ``_pivot_sweep_kernel_2d`` (:84-131), which reads a zero pivot as 1.
    Per step j, with the column c and row r read before it: dinv = 1/d,
    W -= (c dinv) r (the product rounded, then subtracted), then column j =
    c dinv, row j = r dinv and (j, j) = -dinv, in that order; the inverse is
    -W. Unlike "ref" (:func:`pivot_sweep_ref_plain`), column j is written
    out, not folded into the update through r - e_j."""
    nb = D.shape[-1]
    W = D.clone()
    for j in range(nb):
        c = W[..., :, j:j + 1].clone()
        r = W[..., j:j + 1, :].clone()
        d = r[..., :, j:j + 1]
        if guard_zero:
            d = torch.where(d == 0, torch.ones_like(d), d)
        dinv = 1.0 / d
        a = c * dinv
        W -= a * r
        W[..., :, j:j + 1] = a
        W[..., j:j + 1, :] = r * dinv
        W[..., j, j] = -dinv[..., 0, 0]
    return -W


def spd_inverse_nb(D: torch.Tensor, *, lanes: int = 8) -> torch.Tensor:
    """Batched (B, 128, 128) SPD inverse by the round-1 unscaled sweep with
    its zero-pivot guard (the JAX package's ``pallas_spd_inverse_nb``,
    spd_kernels.py:134, kernel ``_pivot_sweep_kernel_2d`` :84).

    On a CUDA tensor (float32, unit column stride; a strided view is read in
    place) this launches csrc/pivot_sweep_2d.cu and counts it in
    ``spd_inverse_nb.launches``; on a CPU tensor it runs
    :func:`sweep_inverse_block_plain` with ``guard_zero``. Any B >= 1: like
    the JAX wrapper it has no Cholesky rule for small batches. ``lanes`` is
    checked and changes no bit (:func:`_check_lanes`).
    """
    if D.ndim != 3 or D.shape[1:] != (NB, NB):
        raise ValueError(f"blocks must be ({NB}, {NB}); got {tuple(D.shape)}")
    _check_lanes(lanes)
    if not _build.launches_kernel("spd_inverse_nb", D):
        return sweep_inverse_block_plain(D, guard_zero=True)
    return _blocks_cuda(spd_inverse_nb, "qps_pivot_sweep_2d", D)


spd_inverse_nb.launches = 0


@fp32_products()
def spd_inverse_sweep(M: torch.Tensor, pivot_inverse=None) -> torch.Tensor:
    """Batched SPD inverse by the flat blocked sweep (the JAX package's
    ``spd_inverse_sweep``, spd_kernels.py:157-181).

    Per 128-block level k of a working copy W of M (n % 128 == 0): Dinv =
    ``pivot_inverse`` of W's diagonal block (default :func:`spd_inverse_nb`,
    read through a strided view), C Dinv from the block column C, W -= (C
    Dinv) R (the product, then the subtraction, R the block row before the
    level), then the block column, row and diagonal become C Dinv, Dinv R
    and -Dinv; the inverse is -W. The products are ``torch.bmm`` in full
    FP32, as the JAX package leaves them to XLA; W is updated in place.
    """
    n = _check_sweep_shape(M)
    if pivot_inverse is None:
        pivot_inverse = spd_inverse_nb
    W = M.reshape(-1, n, n).clone(memory_format=torch.contiguous_format)
    for k in range(n // NB):
        s = slice(k * NB, (k + 1) * NB)
        Dinv = pivot_inverse(W[:, s, s])
        R = W[:, s, :].clone()
        CDinv = torch.bmm(W[:, :, s], Dinv)
        W -= torch.bmm(CDinv, R)
        W[:, :, s] = CDinv
        W[:, s, :] = torch.bmm(Dinv, R)
        W[:, s, s] = -Dinv
    return W.neg_().reshape(M.shape)


HB = 64  # the paired sweep's block size


def pivot_sweep_v3p_plain(D: torch.Tensor) -> torch.Tensor:
    """Plain paired-64 sweep (``_pivot_sweep_v3p_kernel``, the JAX package's
    spd_kernels.py:407-446) on (B, 64, 64): v3's Jacobi scaling and folded
    fixes, but the pivot column is divided by the pivot, a = (W[:, j] -
    e_j) / W[j, j] (:440-441), where v3 multiplies by 1/W[j, j]. The TPU
    kernel packs two blocks into one 128-lane tile; each block's arithmetic
    is its own, so the plain version takes the blocks one by one."""
    nb = D.shape[-1]
    W, s_col, s_row = _jacobi(D)  # updated in place below
    eye = torch.eye(nb, dtype=D.dtype, device=D.device)
    for j in range(nb):
        r = W[..., j:j + 1, :].clone()            # (B, 1, nb) pivot row
        a = (W[..., :, j:j + 1] - eye[:, j:j + 1]) / r[..., :, j:j + 1]
        W -= a * (r - eye[j:j + 1, :])
    return (2.0 * eye - W) * s_col * s_row


def spd_inverse_64p(D: torch.Tensor, *, lanes: int = 8) -> torch.Tensor:
    """Batched (B, 64, 64) SPD inverse by the paired-64 sweep (the JAX
    package's ``pallas_spd_inverse_64p``, spd_kernels.py:449).

    B must be even, as in the JAX package, and at least 4: the JAX wrapper's
    lane loop needs two pairs and fails at B = 2 with ZeroDivisionError,
    where this raises ValueError. On a CUDA tensor (float32, unit column
    stride, strided views read in place) this launches
    csrc/pivot_sweep_v3p.cu and counts it in ``spd_inverse_64p.launches``;
    on a CPU tensor it runs :func:`pivot_sweep_v3p_plain`. ``lanes`` is
    checked and changes no bit.
    """
    if D.ndim != 3 or D.shape[1:] != (HB, HB):
        raise ValueError(f"blocks must be ({HB}, {HB}); got {tuple(D.shape)}")
    B = D.shape[0]
    if B % 2:
        raise ValueError("batch must be even for pairing")
    if B < 4:
        raise ValueError(f"the paired sweep needs at least two pairs of "
                         f"blocks; got B={B}")
    _check_lanes(lanes)
    if not _build.launches_kernel("spd_inverse_64p", D):
        return pivot_sweep_v3p_plain(D)
    return _blocks_cuda(spd_inverse_64p, "qps_pivot_sweep_v3p", D)


spd_inverse_64p.launches = 0


def pivot_sweep_v3p_prev(D: torch.Tensor) -> torch.Tensor:
    """The paired-64 sweep on (B, 64, 64) blocks through the port's first
    kernel of it (csrc/pivot_sweep_v3p.cu: pivot_sweep_v3p_prev_kernel, one
    warp a block), which :func:`spd_inverse_64p`'s kernel must equal bit for
    bit: its witness and timing baseline (no entry point calls it). On a
    CUDA tensor (float32, unit column stride, any B >= 1) it launches that
    kernel and counts it in ``pivot_sweep_v3p_prev.launches``; on a CPU
    tensor it runs :func:`pivot_sweep_v3p_plain`."""
    if D.ndim != 3 or D.shape[1:] != (HB, HB):
        raise ValueError(f"blocks must be ({HB}, {HB}); got {tuple(D.shape)}")
    if not _build.launches_witness("pivot_sweep_v3p_prev", D):
        return pivot_sweep_v3p_plain(D)
    return _blocks_cuda(pivot_sweep_v3p_prev, "qps_pivot_sweep_v3p_prev", D)


pivot_sweep_v3p_prev.launches = 0


@fp32_products()
def spd_inverse_128_schur(D: torch.Tensor, *, lanes: int = 8) -> torch.Tensor:
    """Batched (B, 128, 128) SPD inverse by one 2x2 block Schur step over
    two paired-64 sweeps (the JAX package's ``spd_inverse_128_schur``,
    spd_kernels.py:483-523). With D = [[A, B], [B', C]]:

        inv11 = A^-1,  W = inv11 B,  S = C - B' W,  invS = S^-1,
        X12 = -W invS,  X11 = inv11 - X12 W',
        D^-1 = [[X11, X12], [X12', invS]]

    the two inverses by :func:`spd_inverse_64p`, the products ``torch.bmm``
    in full FP32. An odd B falls back to ``spd_inverse_unrolled(variant=
    "v3")`` (:499-500), whose own rule inverts B < 4 by Cholesky.
    """
    if D.ndim != 3 or D.shape[1:] != (NB, NB):
        raise ValueError(f"blocks must be ({NB}, {NB}); got {tuple(D.shape)}")
    _check_lanes(lanes)
    if D.shape[0] % 2:
        return spd_inverse_unrolled(D, variant="v3")
    A, Bm, C = D[:, :HB, :HB], D[:, :HB, HB:], D[:, HB:, HB:]
    inv11 = spd_inverse_64p(A, lanes=lanes)
    W1 = torch.bmm(inv11, Bm)
    S = C - torch.bmm(Bm.transpose(1, 2), W1)
    invS = spd_inverse_64p(S, lanes=lanes)
    X12 = -torch.bmm(W1, invS)
    X11 = inv11 - torch.bmm(X12, W1.transpose(1, 2))
    top = torch.cat([X11, X12], dim=-1)
    bot = torch.cat([X12.transpose(1, 2), invS], dim=-1)
    return torch.cat([top, bot], dim=-2)


@fp32_products()
def normal_inverse_plain(P: torch.Tensor, A: torch.Tensor, rho: torch.Tensor,
                         sigma: float) -> torch.Tensor:
    """Plain fused normal-matrix inverse (``_normal_inverse_kernel``, the JAX
    package's spd_kernels.py:709-743): per lane M = (P + sigma I) + rho_b
    (A'A), in that order (A'A in full FP32), then the flat blocked sweep
    with the unguarded block pivot (:func:`sweep_inverse_block_plain`)."""
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    AtA = torch.matmul(A.transpose(-1, -2), A)
    M = (P + sigma * eye) + rho.to(P.dtype)[:, None, None] * AtA
    return spd_inverse_sweep(M, pivot_inverse=sweep_inverse_block_plain)


def _check_normal_args(name: str, P: torch.Tensor, A: torch.Tensor,
                       rho: torch.Tensor):
    """(B, n, m) of the normal inverse's operands, or ValueError."""
    B, n, m = P.shape[0], P.shape[-1], A.shape[-2]
    if n % NB or m % NB:
        raise ValueError(f"n, m must be multiples of {NB}; got {(n, m)}")
    if (P.ndim != 3 or P.shape[1] != n or tuple(A.shape) != (B, m, n)
            or tuple(rho.shape) != (B,)):
        raise ValueError(f"{name} takes P (B, n, n), A (B, m, n) and "
                         f"rho (B,); got {tuple(P.shape)}, {tuple(A.shape)}, "
                         f"{tuple(rho.shape)}")
    return B, n, m


def normal_inverse(P: torch.Tensor, A: torch.Tensor, rho: torch.Tensor, *,
                   sigma: float) -> torch.Tensor:
    """(P + sigma I + rho_b A'A)^-1 per lane (the JAX package's
    ``pallas_normal_inverse``, spd_kernels.py:746): P (B, n, n), A (B, m,
    n), rho (B,), one penalty per lane; n and m multiples of 128.

    On CUDA tensors (contiguous float32) this launches
    csrc/normal_inverse.cu's fixed sequence (the gram, then per 128-block
    level the pivot sweep, CD = X[:, s] Dinv and the in-place strip update:
    1 + 3 n/128 kernels, hand-written products throughout; the working
    matrix is the output, with a (B, n, 128) and a (B, 128, 128) workspace)
    and counts one launch per call in ``normal_inverse.launches``; on CPU
    tensors it runs :func:`normal_inverse_plain`.
    """
    B, n, m = _check_normal_args("normal_inverse", P, A, rho)
    if not _build.launches_kernel("normal_inverse", P):
        return normal_inverse_plain(P, A, rho, sigma)
    kw = dict(dtype=torch.float32, device=P.device)
    out, CD = torch.empty((B, n, n), **kw), torch.empty((B, n, NB), **kw)
    Dinv = torch.empty((B, NB, NB), **kw)
    bufs = (P, A, rho, out, CD, Dinv)
    _build.require_cuda_f32("normal_inverse", *bufs)
    _build.launch(normal_inverse, "qps_normal_inverse",
                  *(t.data_ptr() for t in bufs), B, n, m, float(sigma),
                  _build.stream_ptr(P))
    return out


normal_inverse.launches = 0


def normal_inverse_prev(P: torch.Tensor, A: torch.Tensor, rho: torch.Tensor, *,
                        sigma: float) -> torch.Tensor:
    """:func:`normal_inverse` through the port's first kernels of it
    (csrc/normal_inverse.cu: qps_normal_inverse_prev, 64 x 64 SIMT tiles, two
    (B, n, n) working matrices in turn and a (B, 128, n) scratch), which the
    entry point's sequence must equal bit for bit: its witness and timing
    baseline (no entry point calls it). On CUDA tensors (contiguous float32)
    it launches that sequence and counts one launch per call in
    ``normal_inverse_prev.launches``; on CPU tensors it runs
    :func:`normal_inverse_plain`. Other dtypes raise."""
    B, n, m = _check_normal_args("normal_inverse_prev", P, A, rho)
    if not _build.launches_witness("normal_inverse_prev", P, A, rho):
        return normal_inverse_plain(P, A, rho, sigma)
    kw = dict(dtype=torch.float32, device=P.device)
    out, ws = torch.empty((B, n, n), **kw), torch.empty((B, n, n), **kw)
    CD, DR = torch.empty((B, n, NB), **kw), torch.empty((B, NB, n), **kw)
    Dinv = torch.empty((B, NB, NB), **kw)
    bufs = (P, A, rho, out, ws, CD, DR, Dinv)
    _build.require_cuda_f32("normal_inverse_prev", *bufs)
    _build.launch(normal_inverse_prev, "qps_normal_inverse_prev",
                  *(t.data_ptr() for t in bufs), B, n, m, float(sigma),
                  _build.stream_ptr(P))
    return out


normal_inverse_prev.launches = 0
