"""Sparse QP containers for the large matrix-free paths (ELL or CSR storage).

Counterpart of the JAX package's ``core/sparse_problem.py`` (``SparseQP``,
``make_sparse_qp``, ``SparseProxQP``, ``make_sparse_proxqp``, ``_to_ell``).
P and A (and C for the split form) are stored in **ELL format**: every
row padded to the matrix's largest row count, giving a (rows, k) value array
and a (rows, k) int32 column array, padding slots with value 0 and column 0.
A' (and C') is stored as its own row-ELL, so A'w is a gather too, never a
scatter or an atomic. Every ELL product is :func:`~..ops.spmv.ell_matvec`: the
hand-written kernel csrc/ell_matvec.cu on the card, its plain version on the
CPU.

``storage="bcoo"`` (the JAX package's BCOO) keeps the matrices and their
transposes as torch sparse CSR tensors instead, multiplied by ``@``
(cuSPARSE on the card): a library product, as JAX's BCOO product is XLA's.

Both containers are one instance (``batch_shape == ()``), as in the JAX
package.
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


def _product(prob, name: str, v: torch.Tensor) -> torch.Tensor:
    """Matrix ``name`` of a sparse container times v: its CSR tensor's
    ``@`` when stored as CSR, else the ELL product."""
    M = getattr(prob, f"{name}_csr")
    if M is not None:
        return M @ v
    return ell_matvec(getattr(prob, f"{name}_vals"),
                      getattr(prob, f"{name}_cols"), v.contiguous())


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
        return _product(self, "P", v)

    def matvec_A(self, v: torch.Tensor) -> torch.Tensor:
        return _product(self, "A", v)

    def matvec_At(self, w: torch.Tensor) -> torch.Tensor:
        return _product(self, "At", w)

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


@dataclasses.dataclass(frozen=True)
class SparseProxQP:
    """Equality/inequality-split QP (min 0.5 x'Px + q'x s.t. Ax = b, Cx <= d)
    with ELL-format (or CSR) matrices, one instance, for the matrix-free
    prox-ALM path: the inner solve is Jacobi-preconditioned CG on
    M = P + sigma*I + rho(A'A + C'C), so a rho update only refreshes the
    diagonal. ``A_*`` (me rows), ``C_*`` (mi rows) and their transposes
    ``At_*``, ``Ct_*`` as in :class:`SparseQP`; ``dP``, ``dAtA``, ``dCtC``
    the diagonals of P, A'A and C'C. With CSR storage the ELL fields are
    None and the ``*_csr`` fields hold the matrices."""

    P_vals: torch.Tensor | None
    P_cols: torch.Tensor | None
    A_vals: torch.Tensor | None
    A_cols: torch.Tensor | None
    At_vals: torch.Tensor | None
    At_cols: torch.Tensor | None
    C_vals: torch.Tensor | None
    C_cols: torch.Tensor | None
    Ct_vals: torch.Tensor | None
    Ct_cols: torch.Tensor | None
    q: torch.Tensor       # (n,)
    b: torch.Tensor       # (me,)
    d: torch.Tensor       # (mi,)
    dP: torch.Tensor      # (n,) diag(P)
    dAtA: torch.Tensor    # (n,) diag(A'A)
    dCtC: torch.Tensor    # (n,) diag(C'C)
    P_csr: torch.Tensor | None = None
    A_csr: torch.Tensor | None = None
    At_csr: torch.Tensor | None = None
    C_csr: torch.Tensor | None = None
    Ct_csr: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return self.q.shape[0]

    @property
    def n_eq(self) -> int:
        return self.b.shape[0]

    @property
    def n_ineq(self) -> int:
        return self.d.shape[0]

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

    # -- operator protocol (that of ProxQPProblem) --

    def matvec_P(self, v: torch.Tensor) -> torch.Tensor:
        return _product(self, "P", v)

    def matvec_A(self, v: torch.Tensor) -> torch.Tensor:
        return _product(self, "A", v)

    def matvec_At(self, w: torch.Tensor) -> torch.Tensor:
        return _product(self, "At", w)

    def matvec_C(self, v: torch.Tensor) -> torch.Tensor:
        return _product(self, "C", v)

    def matvec_Ct(self, w: torch.Tensor) -> torch.Tensor:
        return _product(self, "Ct", w)

    def diag_P(self) -> torch.Tensor:
        return self.dP

    def diag_AtA(self) -> torch.Tensor:
        return self.dAtA

    def diag_CtC(self) -> torch.Tensor:
        return self.dCtC


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


def _checked(dtype, storage):
    dtype = np.dtype(_NP_DTYPES.get(dtype, dtype))
    if dtype not in (np.float32, np.float64):
        raise ValueError(f"dtype must be float32 or float64; got {dtype}")
    if storage not in ("ell", "bcoo"):
        raise ValueError(f"storage must be 'ell' or 'bcoo'; got {storage!r}")
    return dtype


def _matrices(mats: dict, dtype, storage, dev) -> dict:
    """Each named scipy matrix and its transpose ("<name>t", for the names
    in ``mats`` other than "P") as the container's fields: ELL (vals, cols)
    or CSR."""
    full = {}
    for name, M in mats.items():
        full[name] = M
        if name != "P":
            full[name + "t"] = M.T.tocsr()
    out = {}
    for name, M in full.items():
        if storage == "bcoo":
            out.update({f"{name}_vals": None, f"{name}_cols": None,
                        f"{name}_csr": _to_csr(M, dtype, dev)})
        else:
            vals, cols = _to_ell(M, dtype)
            out.update({f"{name}_vals": torch.tensor(vals, device=dev),
                        f"{name}_cols": torch.tensor(cols, device=dev)})
    return out


def _gram_diag(M, dtype) -> np.ndarray:
    """diag(M'M): the column sums of M's squares."""
    return np.asarray(M.multiply(M).sum(axis=0)).ravel().astype(dtype)


def make_sparse_qp(P, q, A, l, u, dtype=np.float32, storage: str = "ell",
                   device=None) -> SparseQP:
    """Build a SparseQP from scipy sparse matrices (host-side).

    ``dtype``: numpy or torch float32/float64. ``storage``: "ell" (the
    default, the kernel's layout) or "bcoo" (torch sparse CSR). The tensors
    go to the CUDA card unless ``device`` says otherwise (no card: raises).
    """
    dtype = _checked(dtype, storage)
    dev = default_device(device)
    P = sp.csr_matrix(P).astype(dtype)
    A = sp.csr_matrix(A).astype(dtype)

    def t(a):
        return torch.tensor(np.asarray(a, dtype), device=dev)

    return SparseQP(q=t(q), l=t(l), u=t(u), dP=t(P.diagonal()),
                    dAtA=t(_gram_diag(A, dtype)),
                    **_matrices({"P": P, "A": A}, dtype, storage, dev))


def make_sparse_proxqp(P, q, A, b, C, d, dtype=np.float32,
                       storage: str = "ell", device=None) -> SparseProxQP:
    """Build a SparseProxQP from scipy sparse matrices (host-side): the
    operators and Jacobi diagonals of the matrix-free prox path, no
    factorization. ``dtype``, ``storage`` and ``device`` as for
    :func:`make_sparse_qp`."""
    dtype = _checked(dtype, storage)
    dev = default_device(device)
    P, A, C = (sp.csr_matrix(M).astype(dtype) for M in (P, A, C))

    def t(a):
        return torch.tensor(np.asarray(a, dtype), device=dev)

    return SparseProxQP(q=t(q), b=t(b), d=t(d), dP=t(P.diagonal()),
                        dAtA=t(_gram_diag(A, dtype)),
                        dCtC=t(_gram_diag(C, dtype)),
                        **_matrices({"P": P, "A": A, "C": C}, dtype, storage,
                                    dev))
