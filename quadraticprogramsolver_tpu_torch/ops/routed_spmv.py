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
  probe's kernel (one gather-multiply per slot), :func:`row_routed_matvec`
  adds the probe's block sum, one FP32 product with a one-hot matrix.

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
from .linalg import fp32_products


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


# -- kernels --

def _levels(idxJ, V):
    """(G, S, W) operands of one level (the micro kernel) as T = 1."""
    if idxJ.ndim == 3:
        return idxJ[:, None], V[:, None]
    return idxJ, V


def routed_levels_matvec_plain(X, idxJ, V):
    """out[g, l] = sum_t sum_s V[g,t,s,l] * X[s, idxJ[g,t,s,l]]: the sum
    over s per level, then the levels in t order, as the TPU kernel adds
    them (``routed_spmv_probe.py:299-304``)."""
    idxJ, V = _levels(idxJ, V)
    G, T, S, W = idxJ.shape
    g = torch.gather(X.expand(G, T, S, X.shape[-1]), 3, idxJ.long())
    part = (V * g).sum(2)
    acc = torch.zeros((G, W), dtype=part.dtype, device=part.device)
    for t in range(T):
        acc = acc + part[:, t]
    return acc


def routed_levels_matvec(X, idxJ, V):
    """Route-level SpMV out (G, W) from X (S, Wx) and the (G, T, S, W) (or,
    one level, (G, S, W)) indices idxJ into X's columns and values V.

    On a CUDA tensor this launches csrc/routed_spmv.cu and counts it in
    ``routed_levels_matvec.launches``: X and V float32, idxJ int32 with
    every index below Wx (not checked), all contiguous on one card;
    anything else raises. On a CPU tensor it runs
    :func:`routed_levels_matvec_plain`.
    """
    if not _build.launches_kernel("routed_levels_matvec", X):
        return routed_levels_matvec_plain(X, idxJ, V)
    idxJ, V = _levels(idxJ, V)
    if (X.ndim != 2 or idxJ.ndim != 4 or tuple(V.shape) != tuple(idxJ.shape)
            or idxJ.shape[2] != X.shape[0]):
        raise ValueError(f"routed_levels_matvec: X must be (S, Wx) and idxJ, V "
                         f"(G, T, S, W); got {tuple(X.shape)}, "
                         f"{tuple(idxJ.shape)}, {tuple(V.shape)}")
    _build.require_cuda("routed_levels_matvec", (X, torch.float32),
                        (idxJ, torch.int32), (V, torch.float32))
    G, T, S, W = idxJ.shape
    out = torch.empty((G, W), dtype=torch.float32, device=X.device)
    _build.launch(routed_levels_matvec, "qps_routed_levels", X.data_ptr(),
                  idxJ.data_ptr(), V.data_ptr(), out.data_ptr(), G, T, S, W,
                  X.shape[1], _build.stream_ptr(X))
    return out


routed_levels_matvec.launches = 0


def row_routed_rows_plain(Xw, idx, V, L: int):
    """rows[r, k] = V[r, k] * Xw[r // L, idx[r, k]]
    (``row_routed_probe.py:204-209``)."""
    win = torch.arange(idx.shape[0], device=idx.device) // L
    return V * torch.gather(Xw[win], 1, idx.long())


def row_routed_rows(Xw, idx, V, L: int):
    """The row-routed rows (R, Wd) from the window grid Xw (n_win, Wd), the
    (R, Wd) source lanes idx and values V, L rows a window.

    On a CUDA tensor this launches csrc/row_routed.cu and counts it in
    ``row_routed_rows.launches``: Xw and V float32, idx int32 with every
    index below Wd (not checked), all contiguous on one card, R <= n_win * L;
    anything else raises. On a CPU tensor it runs
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


# -- matvecs --

def probe_width(n: int) -> int:
    """The route-level probe's group width W for an n-vector
    (``routed_spmv_probe.py:285``)."""
    return 12544 if n >= 12544 else -(-n // 128) * 128


@dataclasses.dataclass(frozen=True)
class RouteLevels:
    """A matrix packed into route levels, on a device: idxJ/V (G, T, S, W)."""

    idxJ: torch.Tensor
    V: torch.Tensor
    S: int
    W: int
    shape: tuple


def route_levels(P, S: int, W: int, device, dtype=torch.float32) -> RouteLevels:
    """Pack a scipy matrix (:func:`pack_route_levels`) onto ``device``."""
    if S * W < P.shape[1]:
        raise ValueError(f"X (S x W = {S} x {W}) cannot hold x of "
                         f"{P.shape[1]} elements")
    idxJ, V, _, _ = pack_route_levels(P, S, W, np.float64)
    return RouteLevels(torch.tensor(idxJ, device=device),
                       torch.tensor(V, dtype=dtype, device=device), S, W,
                       tuple(P.shape))


def routed_matvec(P, x, S: int = 8, W: int | None = None):
    """y = P x through route levels (``routed_spmv_probe.py:307-325``): X[s,
    j] = x[j*S + s] as an (S, W) array, :func:`routed_levels_matvec`, and
    the first P.shape[0] outputs. ``P`` is a scipy matrix (packed here, with
    W = :func:`probe_width` unless given) or a :class:`RouteLevels`."""
    if not isinstance(P, RouteLevels):
        P = route_levels(P, S, W or probe_width(P.shape[1]), x.device, x.dtype)
    n = P.shape[1]
    X = torch.nn.functional.pad(x[:n], (0, P.S * P.W - n))
    X = X.reshape(P.W, P.S).T.contiguous()
    return routed_levels_matvec(X, P.idxJ, P.V).reshape(-1)[: P.shape[0]]


@dataclasses.dataclass(frozen=True)
class RowRouted:
    """A matrix packed row-routed, on a device: idx/V (R, 128), the one-hot
    block-sum matrix Ssum (n_blk, R), L rows a window, n_win windows."""

    idx: torch.Tensor
    V: torch.Tensor
    Ssum: torch.Tensor
    L: int
    n_win: int
    shape: tuple


def row_routed(P, device, dtype=torch.float32) -> RowRouted:
    """Pack a scipy matrix (:func:`pack_row_routed`) onto ``device``, with
    its one-hot block-sum matrix (Ssum[b_of_row[r], r] = 1)."""
    idx, V, b_of_row, R, L, n_win, n_blk = pack_row_routed(P, np.float64)
    Ssum = torch.zeros((n_blk, R), dtype=dtype, device=device)
    Ssum[torch.tensor(b_of_row, dtype=torch.int64, device=device),
         torch.arange(R, device=device)] = 1.0
    return RowRouted(torch.tensor(idx, device=device),
                     torch.tensor(V, dtype=dtype, device=device), Ssum, L,
                     n_win, tuple(P.shape))


def row_routed_matvec(P, x):
    """y = P x row-routed (``row_routed_probe.py:235-266``): Xw[a, j] =
    x[a*128 + j], :func:`row_routed_rows`, then the block sum Ssum @ rows as
    one FP32 product (:func:`~.linalg.fp32_products`), and the first
    P.shape[0] outputs. ``P`` is a scipy matrix (packed here) or a
    :class:`RowRouted`."""
    if not isinstance(P, RowRouted):
        P = row_routed(P, x.device, x.dtype)
    n = P.shape[1]
    Wd = P.idx.shape[1]
    Xw = torch.nn.functional.pad(x[:n], (0, P.n_win * Wd - n))
    rows = row_routed_rows(Xw.reshape(P.n_win, Wd), P.idx, P.V, P.L)
    with fp32_products():
        y_blk = P.Ssum @ rows
    return y_blk.reshape(-1)[: P.shape[0]]
