"""Sparse QP container for the large matrix-free path (ELL or CSR storage).

Counterpart of the JAX package's ``core/sparse_problem.py`` (``SparseQP``,
``make_sparse_qp``, ``_to_ell``). P and A are stored in **ELL format**: every
row padded to the matrix's largest row count, giving a (rows, k) value array
and a (rows, k) int32 column array, padding slots with value 0 and column 0.
A' is stored as its own row-ELL, so A'w is a gather too, never a scatter or
an atomic. Every ELL product is :func:`~..ops.spmv.ell_matvec`: the
hand-written kernel csrc/ell_matvec.cu on the card, its plain version on the
CPU.

``storage="bcoo"`` (the JAX package's BCOO) keeps P, A and A' as torch
sparse CSR tensors instead, multiplied by ``@`` (cuSPARSE on the card): a
library product, as JAX's BCOO product is XLA's.

SparseQP is one instance (``batch_shape == ()``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.spmv import ell_matvec
from .problem import default_device

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass(frozen=True)
class SparseQP:
    """Box-constrained QP with ELL-format (or CSR) matrices, one instance.

    ``P_*``: (n, kP) rows of P; ``A_*``: (m, kA) rows of A; ``At_*``: (n, kAt)
    rows of A'. ``dP``/``dAtA`` are the diagonals of P and A'A for the Jacobi
    preconditioner. With CSR storage the ELL fields are None and ``P_csr``,
    ``A_csr``, ``At_csr`` (A' materialized) hold the matrices.
    """

    P_vals: torch.Tensor | None
    P_cols: torch.Tensor | None
    A_vals: torch.Tensor | None
    A_cols: torch.Tensor | None
    At_vals: torch.Tensor | None
    At_cols: torch.Tensor | None
    q: torch.Tensor       # (n,)
    l: torch.Tensor       # (m,)
    u: torch.Tensor       # (m,)
    dP: torch.Tensor      # (n,) diag(P)
    dAtA: torch.Tensor    # (n,) diag(A'A)
    P_csr: torch.Tensor | None = None
    A_csr: torch.Tensor | None = None
    At_csr: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return self.q.shape[0]

    @property
    def m(self) -> int:
        return self.l.shape[0]

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return ()

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def is_dense(self) -> bool:
        return False

    # -- operator protocol --

    def matvec_P(self, v: torch.Tensor) -> torch.Tensor:
        if self.P_csr is not None:
            return self.P_csr @ v
        return ell_matvec(self.P_vals, self.P_cols, v.contiguous())

    def matvec_A(self, v: torch.Tensor) -> torch.Tensor:
        if self.A_csr is not None:
            return self.A_csr @ v
        return ell_matvec(self.A_vals, self.A_cols, v.contiguous())

    def matvec_At(self, w: torch.Tensor) -> torch.Tensor:
        if self.At_csr is not None:
            return self.At_csr @ w
        return ell_matvec(self.At_vals, self.At_cols, w.contiguous())

    def diag_P(self) -> torch.Tensor:
        return self.dP

    def diag_AtA(self) -> torch.Tensor:
        return self.dAtA

    def diag_AtWA(self, w: torch.Tensor) -> torch.Tensor:
        """diag(A' diag(w) A): per row of A', sum_k At_vals^2 * w[At_cols]."""
        if self.At_csr is not None:
            # One CSR product on w with squared values (same sparsity).
            At = self.At_csr
            return _csr(At.crow_indices(), At.col_indices(),
                        At.values() ** 2, At.shape) @ w
        return (self.At_vals ** 2 * w[self.At_cols]).sum(-1)

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * (x * self.matvec_P(x)).sum(-1) + (self.q * x).sum(-1)


def _to_ell(M, dtype) -> tuple[np.ndarray, np.ndarray]:
    """scipy sparse -> (vals (rows, k), cols (rows, k)) with zero padding.

    Entry j of row i lands at flat position i*k + (j - indptr[i]) (one
    vectorized scatter, no per-row loop)."""
    M = sp.csr_matrix(M)
    M.sort_indices()
    rows = M.shape[0]
    counts = np.diff(M.indptr)
    k = max(int(counts.max()) if rows else 0, 1)
    vals = np.zeros((rows, k), dtype)
    cols = np.zeros((rows, k), np.int32)
    if M.nnz:
        row_of = np.repeat(np.arange(rows), counts)
        offset = np.arange(M.nnz) - np.repeat(M.indptr[:-1], counts)
        vals[row_of, offset] = M.data
        cols[row_of, offset] = M.indices
    return vals, cols


def _csr(crow, col, values, shape) -> torch.Tensor:
    with warnings.catch_warnings():  # torch flags sparse CSR as beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, col, values, size=tuple(shape),
                                       check_invariants=False)


def _to_csr(M, dtype, device) -> torch.Tensor:
    """scipy sparse -> torch sparse CSR (sorted column indices, int64)."""
    M = sp.csr_matrix(M).astype(dtype)
    M.sort_indices()
    return _csr(torch.tensor(M.indptr.astype(np.int64), device=device),
                torch.tensor(M.indices.astype(np.int64), device=device),
                torch.tensor(M.data, device=device), M.shape)


def make_sparse_qp(P, q, A, l, u, dtype=np.float32, storage: str = "ell",
                   device=None) -> SparseQP:
    """Build a SparseQP from scipy sparse matrices (host-side).

    ``dtype``: numpy or torch float32/float64. ``storage``: "ell" (the
    default, the kernel's layout) or "bcoo" (torch sparse CSR). The tensors
    go to the CUDA card unless ``device`` says otherwise (no card: raises).
    """
    dtype = np.dtype(_NP_DTYPES.get(dtype, dtype))
    if dtype not in (np.float32, np.float64):
        raise ValueError(f"dtype must be float32 or float64; got {dtype}")
    if storage not in ("ell", "bcoo"):
        raise ValueError(f"storage must be 'ell' or 'bcoo'; got {storage!r}")
    dev = default_device(device)
    P = sp.csr_matrix(P).astype(dtype)
    A = sp.csr_matrix(A).astype(dtype)
    dP = np.asarray(P.diagonal(), dtype)
    dAtA = np.asarray(A.multiply(A).sum(axis=0)).ravel().astype(dtype)

    def t(a):
        return torch.tensor(np.asarray(a), device=dev)

    common = dict(q=t(np.asarray(q, dtype)), l=t(np.asarray(l, dtype)),
                  u=t(np.asarray(u, dtype)), dP=t(dP), dAtA=t(dAtA))
    if storage == "bcoo":
        return SparseQP(
            P_vals=None, P_cols=None, A_vals=None, A_cols=None,
            At_vals=None, At_cols=None, P_csr=_to_csr(P, dtype, dev),
            A_csr=_to_csr(A, dtype, dev),
            At_csr=_to_csr(A.T.tocsr(), dtype, dev), **common)
    Pv, Pc = _to_ell(P, dtype)
    Av, Ac = _to_ell(A, dtype)
    Atv, Atc = _to_ell(A.T.tocsr(), dtype)
    return SparseQP(P_vals=t(Pv), P_cols=t(Pc), A_vals=t(Av), A_cols=t(Ac),
                    At_vals=t(Atv), At_cols=t(Atc), **common)
