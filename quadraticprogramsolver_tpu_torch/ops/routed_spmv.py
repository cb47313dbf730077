"""The two routing SpMV formats of the JAX package's probe scripts, as entry
points that no solver calls (csrc/routed_spmv.cu, csrc/row_routed.cu).

* Route levels (``benchmarks/routed_spmv_probe.py``): x lives as X[s, j] =
  x[j*S + s]; output rows get one lane each in groups of W; a group owns T
  levels, and level slot (s, l) holds at most one nnz (r, c) with r = the
  group's row at lane l and c % S = s, stored as j = c // S and its value.
  :func:`routed_levels_matvec` is the probe's level kernel (its square
  micro kernel is the case T = 1), :func:`routed_matvec` the matvec.
* Row routed (``benchmarks/row_routed_probe.py``): x lives as the grid
  Xw[a, j] = x[a*128 + j]; every nnz (r, c) sits in a row of source window
  a = c // 128, at output lane r % 128; :func:`row_routed_rows` is the
  probe's kernel (one gather-multiply per slot), and the probe's block sum
  adds the rows of each output block. :func:`row_routed_matvec` runs both in
  one kernel, :func:`row_routed_blocks`, over a block-major index of the
  used rows; it writes no rows and makes no one-hot product.

Both formats are mostly empty slots on unstructured matrices, so each
device pack carries an occupancy mask (:func:`occupancy_mask`: bit l % 32
of word l // 32 set where the slot holds a nonzero), and the kernels load
only occupied slots. :func:`routed_levels_prev` and :func:`row_routed_rows`
are the first ports' kernels, kept as witnesses.

The packers (:func:`pack_route_levels`, :func:`chunk_tile_census`,
:func:`pack_row_routed`) are the probes' own, with the same results (the
census and the row packer vectorized); their ``dtype`` (float32, the
probes') may be float64 for exact CPU checks. The probe kernels are closures
inside each probe's ``main()``, so the kernels here take new names. The
row-routed probe's bf16 hi/lo split of the block sum (a TPU MXU device for
FP32) and its padding of L to its 1568-row grid step (a Mosaic tiling need)
are not carried over: the sum runs in FP32, and padding rows are zero.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from .. import _build


# -- packers (host, numpy) --

def pack_route_levels(Acsr, S: int, W: int, dtype=np.float32):
    """Greedy packing of a scipy CSR matrix into full-width route levels
    (``routed_spmv_probe.py:75-105``).

    Output rows are assigned one lane each in groups of W lanes; level slot
    (g, t, s, l) holds the j-index/value of the nnz (r, c) with
    r = g*W + l, c = j*S + s, at most one per (g, t, s, l).
    Returns (idxJ, V, T, n_groups) with idxJ/V of shape (n_groups, T, S, W).
    """
    A = sp.csr_matrix(Acsr)
    m, n = A.shape
    ng = -(-m // W)
    r_idx = np.repeat(np.arange(m), np.diff(A.indptr))
    c_idx = A.indices
    g_arr = r_idx // W
    l_arr = r_idx % W
    s_arr = c_idx % S
    j_arr = c_idx // S
    key = (g_arr.astype(np.int64) * S + s_arr) * W + l_arr
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    first = np.r_[True, key_sorted[1:] != key_sorted[:-1]]
    group_start = np.maximum.accumulate(np.where(first, np.arange(len(key)), 0))
    occ = np.arange(len(key)) - group_start
    T = int(occ.max()) + 1 if len(occ) else 1
    idxJ = np.zeros((ng, T, S, W), np.int32)
    V = np.zeros((ng, T, S, W), dtype)
    idxJ[g_arr[order], occ, s_arr[order], l_arr[order]] = j_arr[order]
    V[g_arr[order], occ, s_arr[order], l_arr[order]] = A.data[order]
    return idxJ, V, T, ng


def chunk_tile_census(Acsr, S: int):
    """The tiles a 128-wide-only routing would need
    (``routed_spmv_probe.py:108-138``): every tile is keyed by (output
    128-row block, source 128-lane x-chunk) and holds at most one nnz per
    (c % S, r % 128). Returns (n_tiles, nnz)."""
    A = sp.csr_matrix(Acsr)
    r_idx = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    c_idx = A.indices
    chunk = (c_idx // S) // 128          # which 128-lane window of X
    key = (r_idx.astype(np.int64) // 128) * 10**9 + chunk
    key2 = (key * S + (c_idx % S)) * 128 + (r_idx % 128)
    order = np.argsort(key2, kind="stable")
    ks = key2[order]
    first = np.r_[True, ks[1:] != ks[:-1]]
    gs = np.maximum.accumulate(np.where(first, np.arange(len(ks)), 0))
    occ = np.arange(len(ks)) - gs
    # Tiles per (block, chunk) pair: its slots' largest multiplicity.
    _, pair = np.unique(key[order], return_inverse=True)
    most = np.full(pair.max() + 1 if len(pair) else 0, -1, np.int64)
    np.maximum.at(most, pair, occ)
    return int((most + 1).sum()), A.nnz


def pack_row_routed(Acsr, dtype=np.float32):
    """Pack a scipy CSR matrix into row-routed form
    (``row_routed_probe.py:77-136``).

    Returns (idx, V, b_of_row, R, L_max, n_win, n_blk):
      * rows are (window a, layer) pairs, laid out a-major (row r belongs to
        window r // L_max), R = n_win * L_max;
      * idx/V: (R, 128) int32 / ``dtype``: lane k of a row holds the source
        lane and the value of the nnz routed there (V = 0 empty);
      * b_of_row: (R,) int32 output block of each row (0 for empty rows).
    Within one window the nnz of one (a, b) pair take one layer per output
    lane collision.
    """
    A = sp.csr_matrix(Acsr)
    m, n = A.shape
    n_blk = -(-m // 128)
    n_win = -(-n // 128)
    r_idx = np.repeat(np.arange(m), np.diff(A.indptr))
    c_idx = A.indices
    a_arr = c_idx // 128
    l_arr = c_idx % 128
    b_arr = r_idx // 128
    k_arr = r_idx % 128

    key_abk = ((a_arr.astype(np.int64) * n_blk + b_arr) * 128 + k_arr)
    order = np.argsort(key_abk, kind="stable")
    ks = key_abk[order]
    first = np.r_[True, ks[1:] != ks[:-1]]
    gs = np.maximum.accumulate(np.where(first, np.arange(len(ks)), 0))
    occ = np.arange(len(ks)) - gs                       # layer within (a,b,k)
    ab_layer = ((a_arr[order].astype(np.int64) * n_blk + b_arr[order])
                * 64 + occ)
    uniq, row_of = np.unique(ab_layer, return_inverse=True)
    a_of_uniq = (uniq // 64) // n_blk
    b_of_uniq = (uniq // 64) % n_blk
    counts = np.bincount(a_of_uniq, minlength=n_win)
    L_max = int(counts.max()) if counts.size else 1
    # The slot of each unique row within its window (uniq is a-major).
    slot = np.arange(len(uniq)) - (np.cumsum(counts) - counts)[a_of_uniq]
    row_id_of_uniq = a_of_uniq * L_max + slot
    R = n_win * L_max
    idx = np.zeros((R, 128), np.int32)
    V = np.zeros((R, 128), dtype)
    rows_full = row_id_of_uniq[row_of]                  # per sorted nnz
    idx[rows_full, k_arr[order]] = l_arr[order]
    V[rows_full, k_arr[order]] = A.data[order]
    b_of_row = np.zeros(R, np.int32)
    b_of_row[row_id_of_uniq] = b_of_uniq
    return idx, V, b_of_row, R, L_max, n_win, n_blk


def occupancy_mask(V):
    """The occupancy bits of packed values V (..., W): (..., ceil(W / 32))
    uint32 words, bit l % 32 of word l // 32 set where V[..., l] != 0."""
    nz = np.asarray(V) != 0
    W = nz.shape[-1]
    Wm = -(-W // 32)
    nz = np.pad(nz, [(0, 0)] * (nz.ndim - 1) + [(0, Wm * 32 - W)])
    words = np.packbits(nz, axis=-1, bitorder="little")
    return np.ascontiguousarray(words).view("<u4").astype(np.uint32)


def row_routed_index(V, b_of_row, n_blk: int):
    """The block-major index of a row-routed pack (V, b_of_row from
    :func:`pack_row_routed`): (mask, order, blk_ptr).

    mask is :func:`occupancy_mask` (R, 4); order (int32) the used rows,
    those with a nonzero, sorted stably by output block (so ascending within
    a block); blk_ptr (int32, n_blk + 1) where each block's rows start in
    order. Padding rows (all zero) are left out, as is a row whose every
    entry is an explicit zero.
    """
    mask = occupancy_mask(V)
    used = np.flatnonzero(mask.any(axis=1))
    blk = np.asarray(b_of_row)[used]
    order = used[np.argsort(blk, kind="stable")].astype(np.int32)
    blk_ptr = np.zeros(n_blk + 1, np.int32)
    blk_ptr[1:] = np.cumsum(np.bincount(blk, minlength=n_blk))
    return mask, order, blk_ptr


# -- kernels --

def _levels(idxJ, V):
    """(G, S, W) operands of one level (the micro kernel) as T = 1."""
    if idxJ.ndim == 3:
        return idxJ[:, None], V[:, None]
    return idxJ, V


def mask_bits(mask, W: int):
    """The bits of :func:`occupancy_mask` words (..., ceil(W / 32)) as a
    boolean tensor (..., W)."""
    lanes = torch.arange(W, device=mask.device)
    # As int32 and widened: a CUDA uint32 tensor takes views and copies only.
    words = mask.view(torch.int32).to(torch.int64)[..., lanes // 32]
    return ((words >> (lanes % 32)) & 1).bool()


def routed_levels_matvec_plain(X, idxJ, V, mask=None):
    """out[g, l] = sum_t sum_s V[g,t,s,l] * X[s, idxJ[g,t,s,l]]: the sum
    over s per level, then the levels in t order, as the TPU kernel adds
    them (``routed_spmv_probe.py:299-304``). With ``mask`` (the
    :func:`occupancy_mask` of V) the products of clear slots are left out,
    as the kernel leaves them out."""
    idxJ, V = _levels(idxJ, V)
    G, T, S, W = idxJ.shape
    g = torch.gather(X.expand(G, T, S, X.shape[-1]), 3, idxJ.long())
    prod = V * g
    if mask is not None:
        prod = torch.where(mask_bits(mask.reshape(G, T, S, -1), W), prod, 0.0)
    part = prod.sum(2)
    acc = torch.zeros((G, W), dtype=part.dtype, device=part.device)
    for t in range(T):
        acc = acc + part[:, t]
    return acc


def _check_levels(name, X, idxJ, V, mask=None):
    if (X.ndim != 2 or idxJ.ndim != 4 or tuple(V.shape) != tuple(idxJ.shape)
            or idxJ.shape[2] != X.shape[0]):
        raise ValueError(f"{name}: X must be (S, Wx) and idxJ, V (G, T, S, W); "
                         f"got {tuple(X.shape)}, {tuple(idxJ.shape)}, "
                         f"{tuple(V.shape)}")
    operands = [(X, torch.float32), (idxJ, torch.int32), (V, torch.float32)]
    if mask is not None:
        want = (*idxJ.shape[:3], -(-idxJ.shape[3] // 32))
        if tuple(mask.shape) != want:
            raise ValueError(f"{name}: mask must be {want}; got "
                             f"{tuple(mask.shape)}")
        operands.append((mask, torch.uint32))
    _build.require_cuda(name, *operands)


def routed_levels_matvec(X, idxJ, V, mask=None):
    """Route-level SpMV out (G, W) from X (S, Wx) and the (G, T, S, W) (or,
    one level, (G, S, W)) indices idxJ into X's columns and values V, with
    an optional occupancy mask (G, T, S, ceil(W / 32)) of V
    (:func:`occupancy_mask`): with it the kernel loads only occupied slots.
    A clear slot's product is left out, which changes the result only where
    x is not finite (or in the sign of a zero).

    On a CUDA tensor this launches csrc/routed_spmv.cu's
    ``routed_levels_kernel`` (at T = 1 without a mask, the micro kernel, its
    ``routed_levels_prev_kernel``, which the level split does not beat
    there) and counts it in ``routed_levels_matvec.launches``: X and V
    float32, idxJ int32 with every index below Wx (not checked), mask
    uint32, all contiguous on one card; anything else raises. On a CPU
    tensor it runs :func:`routed_levels_matvec_plain`.
    """
    if not _build.launches_kernel("routed_levels_matvec", X):
        return routed_levels_matvec_plain(X, idxJ, V, mask)
    idxJ, V = _levels(idxJ, V)
    if mask is not None and mask.ndim == 3:
        mask = mask[:, None]
    _check_levels("routed_levels_matvec", X, idxJ, V, mask)
    G, T, S, W = idxJ.shape
    out = torch.empty((G, W), dtype=torch.float32, device=X.device)
    _build.launch(routed_levels_matvec, "qps_routed_levels", X.data_ptr(),
                  idxJ.data_ptr(), V.data_ptr(),
                  None if mask is None else mask.data_ptr(), out.data_ptr(),
                  G, T, S, W, X.shape[1], _build.stream_ptr(X))
    return out


routed_levels_matvec.launches = 0


def routed_levels_prev(X, idxJ, V):
    """The first port's route-level kernel (csrc/routed_spmv.cu's
    ``routed_levels_prev_kernel``: one thread an output, every slot read),
    kept as the witness of :func:`routed_levels_matvec`, which gives its
    bits wherever x is finite (and launches this kernel itself at T = 1
    without a mask). Counted in ``routed_levels_prev.launches``; no entry
    point calls it. On a CPU tensor it runs
    :func:`routed_levels_matvec_plain`."""
    if not _build.launches_witness("routed_levels_prev", X, V):
        return routed_levels_matvec_plain(X, idxJ, V)
    idxJ, V = _levels(idxJ, V)
    _check_levels("routed_levels_prev", X, idxJ, V)
    G, T, S, W = idxJ.shape
    out = torch.empty((G, W), dtype=torch.float32, device=X.device)
    _build.launch(routed_levels_prev, "qps_routed_levels_prev", X.data_ptr(),
                  idxJ.data_ptr(), V.data_ptr(), out.data_ptr(), G, T, S, W,
                  X.shape[1], _build.stream_ptr(X))
    return out


routed_levels_prev.launches = 0


def row_routed_rows_plain(Xw, idx, V, L: int):
    """rows[r, k] = V[r, k] * Xw[r // L, idx[r, k]]
    (``row_routed_probe.py:204-209``)."""
    win = torch.arange(idx.shape[0], device=idx.device) // L
    return V * torch.gather(Xw[win], 1, idx.long())


def row_routed_rows(Xw, idx, V, L: int):
    """The row-routed rows (R, Wd) from the window grid Xw (n_win, Wd), the
    (R, Wd) source lanes idx and values V, L rows a window: the probe's
    kernel, kept as the witness of :func:`row_routed_blocks` (its rows,
    summed into their blocks).

    On a CUDA tensor this launches csrc/row_routed.cu's ``row_routed_kernel``
    and counts it in ``row_routed_rows.launches``: Xw and V float32, idx
    int32 with every index below Wd (not checked), all contiguous on one
    card, R <= n_win * L; anything else raises. On a CPU tensor it runs
    :func:`row_routed_rows_plain`.
    """
    if not _build.launches_kernel("row_routed_rows", Xw):
        return row_routed_rows_plain(Xw, idx, V, L)
    if (Xw.ndim != 2 or idx.ndim != 2 or tuple(V.shape) != tuple(idx.shape)
            or idx.shape[1] != Xw.shape[1] or L < 1
            or idx.shape[0] > Xw.shape[0] * L):
        raise ValueError(f"row_routed_rows: Xw must be (n_win, Wd) and idx, V "
                         f"(R, Wd) with R <= n_win * L; got {tuple(Xw.shape)}, "
                         f"{tuple(idx.shape)}, {tuple(V.shape)}, L={L}")
    _build.require_cuda("row_routed_rows", (Xw, torch.float32),
                        (idx, torch.int32), (V, torch.float32))
    R, Wd = idx.shape
    rows = torch.empty((R, Wd), dtype=torch.float32, device=Xw.device)
    _build.launch(row_routed_rows, "qps_row_routed", Xw.data_ptr(),
                  idx.data_ptr(), V.data_ptr(), rows.data_ptr(), R, Wd, L,
                  _build.stream_ptr(Xw))
    return rows


row_routed_rows.launches = 0


def block_sum(rows, order, blk_ptr):
    """Rows (R, Wd) summed into their output blocks (n_blk, Wd) through a
    block-major index (:func:`row_routed_index`): block b adds
    rows[order[blk_ptr[b]:blk_ptr[b + 1]]] by ``index_add_``, in that order
    (ascending r in a block)."""
    o = order.long()
    n_blk = blk_ptr.numel() - 1
    blk = torch.repeat_interleave(torch.arange(n_blk, device=o.device),
                                  torch.diff(blk_ptr.long()),
                                  output_size=o.numel())
    y = torch.zeros((n_blk, rows.shape[1]), dtype=rows.dtype,
                    device=rows.device)
    return y.index_add_(0, blk, rows[o])


def row_routed_blocks_plain(Xw, idx, V, mask, order, blk_ptr, L: int):
    """y[b, k] = sum of V[r, k] * Xw[r // L, idx[r, k]] over block b's rows
    (order[blk_ptr[b]:blk_ptr[b + 1]]), clear slots of ``mask`` left out:
    the rows as :func:`row_routed_rows_plain` makes them, then
    :func:`block_sum`."""
    rows = row_routed_rows_plain(Xw, idx, V, L)
    rows = torch.where(mask_bits(mask, idx.shape[1]), rows, 0.0)
    return block_sum(rows, order, blk_ptr)


def row_routed_blocks(Xw, idx, V, mask, order, blk_ptr, L: int):
    """The fused row-routed matvec y (n_blk, 128): every used row's
    gather-multiply summed into its output block in one launch, no rows
    written. Xw (n_win, 128) is the window grid, idx/V (R, 128) the pack
    (L rows a window), mask (R, 4) its :func:`occupancy_mask`, and
    order/blk_ptr its block-major index (:func:`row_routed_index`). A clear
    slot (empty, or an explicit zero of P) is skipped, which changes y only
    where x is not finite.

    On a CUDA tensor this launches csrc/row_routed.cu's
    ``row_routed_blocks_kernel`` and counts it in
    ``row_routed_blocks.launches``: Xw and V float32, idx, order and blk_ptr
    int32, mask uint32, all contiguous on one card, Xw, idx, V and mask
    16-byte aligned, R <= n_win * L; the indices are not checked. Anything
    else raises. Deterministic: two calls give the same bits. On a CPU
    tensor it runs :func:`row_routed_blocks_plain`.
    """
    if not _build.launches_kernel("row_routed_blocks", Xw):
        return row_routed_blocks_plain(Xw, idx, V, mask, order, blk_ptr, L)
    if (Xw.ndim != 2 or Xw.shape[1] != 128 or idx.ndim != 2
            or tuple(V.shape) != tuple(idx.shape) or idx.shape[1] != 128
            or tuple(mask.shape) != (idx.shape[0], 4) or order.ndim != 1
            or blk_ptr.ndim != 1 or blk_ptr.numel() < 1 or L < 1
            or idx.shape[0] > Xw.shape[0] * L):
        raise ValueError(
            f"row_routed_blocks: Xw must be (n_win, 128), idx and V (R, 128), "
            f"mask (R, 4), order and blk_ptr vectors, R <= n_win * L; got "
            f"{tuple(Xw.shape)}, {tuple(idx.shape)}, {tuple(V.shape)}, "
            f"{tuple(mask.shape)}, {tuple(order.shape)}, "
            f"{tuple(blk_ptr.shape)}, L={L}")
    _build.require_cuda("row_routed_blocks", (Xw, torch.float32),
                        (idx, torch.int32), (V, torch.float32),
                        (mask, torch.uint32), (order, torch.int32),
                        (blk_ptr, torch.int32))
    for i, t in enumerate((Xw, idx, V, mask)):
        if t.data_ptr() % 16:
            raise ValueError(f"row_routed_blocks: operand {i} is not 16-byte "
                             "aligned")
    n_blk = blk_ptr.numel() - 1
    y = torch.empty((n_blk, 128), dtype=torch.float32, device=Xw.device)
    _build.launch(row_routed_blocks, "qps_row_routed_blocks", Xw.data_ptr(),
                  idx.data_ptr(), V.data_ptr(), mask.data_ptr(),
                  order.data_ptr(), blk_ptr.data_ptr(), y.data_ptr(), n_blk, L,
                  _build.stream_ptr(Xw))
    return y


row_routed_blocks.launches = 0


# -- matvecs --

def probe_width(n: int) -> int:
    """The route-level probe's group width W for an n-vector
    (``routed_spmv_probe.py:285``)."""
    return 12544 if n >= 12544 else -(-n // 128) * 128


@dataclasses.dataclass(frozen=True)
class RouteLevels:
    """A matrix packed into route levels, on a device: idxJ/V (G, T, S, W)
    and V's occupancy mask (G, T, S, ceil(W / 32))."""

    idxJ: torch.Tensor
    V: torch.Tensor
    mask: torch.Tensor
    S: int
    W: int
    shape: tuple


def route_levels(P, S: int, W: int, device, dtype=torch.float32) -> RouteLevels:
    """Pack a scipy matrix (:func:`pack_route_levels`) onto ``device``, with
    its occupancy mask."""
    if S * W < P.shape[1]:
        raise ValueError(f"X (S x W = {S} x {W}) cannot hold x of "
                         f"{P.shape[1]} elements")
    idxJ, V, _, _ = pack_route_levels(P, S, W, np.float64)
    return RouteLevels(torch.tensor(idxJ, device=device),
                       torch.tensor(V, dtype=dtype, device=device),
                       torch.from_numpy(occupancy_mask(V)).to(device), S, W,
                       tuple(P.shape))


def routed_matvec(P, x, S: int = 8, W: int | None = None):
    """y = P x through route levels (``routed_spmv_probe.py:307-325``): X[s,
    j] = x[j*S + s] as an (S, W) array, :func:`routed_levels_matvec` with
    the pack's occupancy mask, and the first P.shape[0] outputs. ``P`` is a
    scipy matrix (packed here, with W = :func:`probe_width` unless given) or
    a :class:`RouteLevels`."""
    if not isinstance(P, RouteLevels):
        P = route_levels(P, S, W or probe_width(P.shape[1]), x.device, x.dtype)
    n = P.shape[1]
    X = torch.nn.functional.pad(x[:n], (0, P.S * P.W - n))
    X = X.reshape(P.W, P.S).T.contiguous()
    y = routed_levels_matvec(X, P.idxJ, P.V, P.mask)
    return y.reshape(-1)[: P.shape[0]]


@dataclasses.dataclass(frozen=True)
class RowRouted:
    """A matrix packed row-routed, on a device: idx/V (R, 128), L rows a
    window, n_win windows, and the block-major index of
    :func:`row_routed_index` (mask (R, 4), order, blk_ptr)."""

    idx: torch.Tensor
    V: torch.Tensor
    mask: torch.Tensor
    order: torch.Tensor
    blk_ptr: torch.Tensor
    L: int
    n_win: int
    shape: tuple


def row_routed(P, device, dtype=torch.float32) -> RowRouted:
    """Pack a scipy matrix (:func:`pack_row_routed`) onto ``device``, with
    its block-major index (:func:`row_routed_index`)."""
    idx, V, b_of_row, R, L, n_win, n_blk = pack_row_routed(P, np.float64)
    mask, order, blk_ptr = row_routed_index(V, b_of_row, n_blk)
    return RowRouted(torch.tensor(idx, device=device),
                     torch.tensor(V, dtype=dtype, device=device),
                     torch.from_numpy(mask).to(device),
                     torch.tensor(order, device=device),
                     torch.tensor(blk_ptr, device=device), L, n_win,
                     tuple(P.shape))


def row_routed_matvec(P, x):
    """y = P x row-routed (``row_routed_probe.py:235-266``): Xw[a, j] =
    x[a*128 + j], the fused :func:`row_routed_blocks` (the probe's rows and
    block sum in one kernel), and the first P.shape[0] outputs. ``P`` is a
    scipy matrix (packed here) or a :class:`RowRouted`."""
    if not isinstance(P, RowRouted):
        P = row_routed(P, x.device, x.dtype)
    n = P.shape[1]
    Wd = P.idx.shape[1]
    Xw = torch.nn.functional.pad(x[:n], (0, P.n_win * Wd - n))
    y_blk = row_routed_blocks(Xw.reshape(P.n_win, Wd), P.idx, P.V, P.mask,
                              P.order, P.blk_ptr, P.L)
    return y_blk.reshape(-1)[: P.shape[0]]
