"""Host-side problem generation for the large sparse path (numpy + scipy).

A copy of the JAX package's ``problems/generator.py: QPData, _sprandn,
generate_large_sparse_qp`` (that module cannot be imported here: its package
imports jax). From the same seed it makes the same scipy matrices and numpy
vectors, element for element.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class QPData:
    """Host-side generated problem (sparse matrices + dense vectors)."""

    P: sp.csc_matrix
    q: np.ndarray
    A: sp.csc_matrix
    l: np.ndarray
    u: np.ndarray

    @property
    def n(self) -> int:
        return self.P.shape[0]

    @property
    def m(self) -> int:
        return self.A.shape[0]

    def dense(self, dtype=np.float64):
        return (
            np.asarray(self.P.toarray(), dtype),
            np.asarray(self.q, dtype),
            np.asarray(self.A.toarray(), dtype),
            np.asarray(self.l, dtype),
            np.asarray(self.u, dtype),
        )


def _sprandn(rng: np.random.Generator, rows: int, cols: int,
             density: float) -> sp.csc_matrix:
    """scipy analogue of Julia's ``sprandn`` (normal nonzeros)."""
    return sp.random(
        rows, cols, density=density, format="csc",
        random_state=np.random.default_rng(rng.integers(2**63)),
        data_rvs=lambda size: rng.standard_normal(size),
    )


def generate_large_sparse_qp(
    num_elements: int,
    num_constraints: int = 0,
    nnz_per_row: int = 3,
    seed: int = 0,
) -> QPData:
    """Large sparse feasible QP for the matrix-free PCG path (the n = 1e5
    regime of BASELINE.md config 4).

    P = I + B'B with B ~ sparse normal (nnz_per_row/n density, 1/sqrt(k)
    scaled): SPD, well-conditioned, ~k^2 nnz per row. A ~ sparse normal
    rows; the bounds bracket A @ x0 for a random x0, so the instance is
    feasible by construction.
    """
    rng = np.random.default_rng(seed)
    n = num_elements
    m = num_constraints or n // 2
    k = nnz_per_row
    B = _sprandn(rng, n, n, k / n) / np.sqrt(k)
    P = (sp.identity(n) + B.T @ B).tocsc()
    q = rng.standard_normal(n)
    A = _sprandn(rng, m, n, k / n).tocsc()
    x0 = rng.standard_normal(n)
    Ax0 = A @ x0
    l = Ax0 - rng.random(m)
    u = Ax0 + rng.random(m)
    return QPData(P, q, A, l, u)
