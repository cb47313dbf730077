"""Host-side problem generation (numpy + scipy).

A copy of the JAX package's ``problems/generator.py`` (that module cannot be
imported here: its package imports jax): the 9 OSQP-paper benchmark families
(``ProblemClass``, ``ALL_CLASSES``, ``generate_random_qp``), their batched
fleet (``generate_batch``, a port :class:`~..core.problem.QP` on the CUDA
card unless the caller names another device) and the large sparse instance
of the matrix-free path (``generate_large_sparse_qp``). From the same seed
it makes the same scipy matrices and numpy vectors, element for element.

Quirk kept for parity: in the generic branch masked *upper* bounds are set
to 1.0 (the reference's ``vU[vI] .= vI[vI]``), almost certainly meant for
the lower ones.
"""

from __future__ import annotations

import dataclasses
import enum

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


class ProblemClass(enum.Enum):
    """Mirrors `@enum ProblemClass` (GenerateQuadraticProgram.jl:6)."""

    RANDOM_QP = "random_qp"
    INEQUALITY_QP = "inequality_qp"
    EQUALITY_QP = "equality_qp"
    OPTIMAL_CONTROL = "optimal_control"
    PORTFOLIO = "portfolio"
    LASSO = "lasso"
    HUBER = "huber"
    SVM = "svm"
    ISOTONIC = "isotonic"


ALL_CLASSES = tuple(ProblemClass)


def _speye(k: int, scale: float = 1.0) -> sp.csc_matrix:
    return sp.identity(k, format="csc") * scale


def generate_random_qp(
    problem_class: ProblemClass,
    num_elements: int = 1000,
    num_constraints: int = 0,
    seed: int | np.random.Generator = 0,
) -> QPData:
    """Generate one instance of the given family.

    ``num_constraints=0`` selects the OSQP-paper default ratio for the family,
    exactly as the reference (GenerateQuadraticProgram.jl:18,23,28,40,51,65,80).
    """
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    n = num_elements
    mc = num_constraints

    generic = (
        ProblemClass.RANDOM_QP,
        ProblemClass.INEQUALITY_QP,
        ProblemClass.EQUALITY_QP,
        ProblemClass.OPTIMAL_CONTROL,
    )
    if problem_class in generic:
        # GenerateQuadraticProgram.jl:10-36
        density, alpha = 0.15, 1e-2
        M = _sprandn(rng, n, n, density)
        P = (M.T @ M + _speye(n, alpha)).tocsc()
        q = rng.standard_normal(n)
        if problem_class is ProblemClass.INEQUALITY_QP:
            m = mc or 10 * n
            A = _sprandn(rng, m, n, density)
            l = -rng.random(m)
            u = rng.random(m)
        elif problem_class is ProblemClass.EQUALITY_QP:
            m = mc or n // 2
            A = _sprandn(rng, m, n, density)
            l = rng.standard_normal(m)
            u = l.copy()
        else:  # RANDOM_QP and OPTIMAL_CONTROL share the masked-bounds branch (:27-36)
            m = mc or n // 2
            A = _sprandn(rng, m, n, density)
            l = -rng.random(m)
            u = rng.random(m)
            mask = rng.random(m) <= 0.15
            l[mask] = u[mask]
            mask = rng.random(m) <= 0.15
            u[mask] = 1.0  # reference quirk `vU[vI] .= vI[vI]` (:35), kept for parity
        return QPData(P, q, A.tocsc(), l, u)

    if problem_class is ProblemClass.PORTFOLIO:
        # GenerateQuadraticProgram.jl:37-47. Vars = [assets(n); factors(k)].
        density = 0.5
        k = mc or max(5, n // 100)
        D = sp.diags(rng.random(n) * np.sqrt(k), format="csc")
        P = sp.block_diag([D, _speye(k)], format="csc")
        q = np.concatenate([rng.standard_normal(n), np.zeros(k)])
        F = _sprandn(rng, n, k, density)
        A = sp.vstack(
            [
                sp.hstack([F.T, -_speye(k)]),
                sp.hstack([sp.csc_matrix(np.ones((1, n))), sp.csc_matrix((1, k))]),
                sp.hstack([_speye(n), sp.csc_matrix((n, k))]),
            ],
            format="csc",
        )
        l = np.concatenate([np.zeros(k), [1.0], np.zeros(n)])
        u = np.concatenate([np.zeros(k), [1.0], np.ones(n)])
        return QPData(P, q, A, l, u)

    if problem_class is ProblemClass.LASSO:
        # GenerateQuadraticProgram.jl:48-61. Vars = [x(n); y(m); t(n)].
        density = 0.15
        m = mc or n * 100
        Ad = _sprandn(rng, m, n, density)
        x_true = (rng.standard_normal(n) / np.sqrt(n)) * (rng.random(n) > 0.5)
        b = Ad @ x_true + rng.standard_normal(m)
        lam = np.abs(Ad.T @ b).max() / 5.0
        P = sp.block_diag(
            [sp.csc_matrix((n, n)), _speye(m, 2.0), sp.csc_matrix((n, n))], format="csc")
        q = np.concatenate([np.zeros(n + m), lam * np.ones(n)])
        A = sp.vstack(
            [
                sp.hstack([Ad, -_speye(m), sp.csc_matrix((m, n))]),
                sp.hstack([_speye(n), sp.csc_matrix((n, m)), -_speye(n)]),
                sp.hstack([_speye(n), sp.csc_matrix((n, m)), _speye(n)]),
            ],
            format="csc",
        )
        l = np.concatenate([b, np.full(n, -np.inf), np.zeros(n)])
        u = np.concatenate([b, np.zeros(n), np.full(n, np.inf)])
        return QPData(P, q, A, l, u)

    if problem_class is ProblemClass.HUBER:
        # GenerateQuadraticProgram.jl:62-76. Vars = [x(n); u(m); r(m); s(m)].
        density = 0.15
        m = mc or n * 100
        Ad = _sprandn(rng, m, n, density)
        x_true = rng.standard_normal(n) / np.sqrt(n)
        inlier = rng.random(m) < 0.95
        b = Ad @ x_true + 0.5 * inlier * rng.standard_normal(m) + 10.0 * (~inlier) * rng.random(m)
        P = sp.block_diag(
            [sp.csc_matrix((n, n)), _speye(m, 2.0), sp.csc_matrix((2 * m, 2 * m))],
            format="csc",
        )
        q = np.concatenate([np.zeros(n + m), 2.0 * np.ones(2 * m)])
        I_m = _speye(m)
        Z_mn = sp.csc_matrix((m, n + m))
        A = sp.vstack(
            [
                sp.hstack([Ad, -I_m, -I_m, I_m]),
                sp.hstack([Z_mn, I_m, sp.csc_matrix((m, m))]),
                sp.hstack([Z_mn, sp.csc_matrix((m, m)), I_m]),
            ],
            format="csc",
        )
        l = np.concatenate([b, np.zeros(2 * m)])
        u = np.concatenate([b, np.full(2 * m, np.inf)])
        return QPData(P, q, A, l, u)

    if problem_class is ProblemClass.SVM:
        # GenerateQuadraticProgram.jl:77-92. Vars = [w(n); t(m)].
        density = 0.15
        m = mc or n * 100
        half = m // 2
        m = 2 * half
        lam = 1.0
        b = np.concatenate([np.ones(half), -np.ones(half)])
        Au = _sprandn(rng, half, n, density)
        Al = _sprandn(rng, half, n, density)
        upper = Au / np.sqrt(m) + (Au != 0).multiply(1.0 / m)
        lower = Al / np.sqrt(m) - (Al != 0).multiply(1.0 / m)
        Ad = sp.vstack([upper, lower], format="csc")
        P = sp.block_diag([_speye(n, 2.0), sp.csc_matrix((m, m))], format="csc")
        q = lam * np.concatenate([np.zeros(n), np.ones(m)])
        A = sp.vstack(
            [
                sp.hstack([sp.diags(b) @ Ad, -_speye(m)]),
                sp.hstack([sp.csc_matrix((m, n)), _speye(m)]),
            ],
            format="csc",
        )
        l = np.concatenate([np.full(m, -np.inf), np.zeros(m)])
        u = np.concatenate([-np.ones(m), np.full(m, np.inf)])
        return QPData(P, q, A, l, u)

    if problem_class is ProblemClass.ISOTONIC:
        # GenerateQuadraticProgram.jl:93-109.
        density, alpha = 0.25, 1e-2
        M = _sprandn(rng, n, n, density)
        P = (M.T @ M + _speye(n, alpha)).tocsc()
        q = rng.standard_normal(n)
        ones = np.ones(n - 1)
        if rng.random() >= 0.5:  # monotone non-increasing
            A = sp.diags([ones, -ones], offsets=[0, 1], shape=(n - 1, n), format="csc")
        else:  # monotone non-decreasing
            A = sp.diags([-ones, ones], offsets=[0, 1], shape=(n - 1, n), format="csc")
        l = np.zeros(n - 1)
        u = 10.0 * np.ones(n - 1)
        return QPData(P, q, A, l, u)

    raise ValueError(f"unknown problem class {problem_class}")


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


def generate_batch(
    problem_class: ProblemClass,
    batch: int,
    num_elements: int,
    num_constraints: int = 0,
    seed: int = 0,
    dtype=np.float32,
    device=None,
):
    """Generate ``batch`` same-shape instances and stack them into a batched
    :class:`~..core.problem.QP` of shape (batch, ...), in ``dtype``, on
    ``device`` (the CUDA card by default; ``device="cpu"`` on the host)."""
    from ..core.problem import make_qp

    rng = np.random.default_rng(seed)
    datas = [
        generate_random_qp(problem_class, num_elements, num_constraints, rng)
        for _ in range(batch)
    ]
    shapes = {(d.n, d.m) for d in datas}
    if len(shapes) != 1:
        raise ValueError(f"instances have inconsistent shapes: {shapes}")
    dense = [d.dense(dtype) for d in datas]
    P, q, A, l, u = (np.stack([inst[i] for inst in dense]) for i in range(5))
    return make_qp(P, q, A, l, u, device=device)
