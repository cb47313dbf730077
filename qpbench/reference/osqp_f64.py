"""Host-side float64 reference solver: the plain reference that decides a
cell's ``correct``.

A scalar NumPy/SciPy OSQP-ADMM on one box-constrained QP

    min 0.5 x'Px + q'x  s.t.  l <= Ax <= u,

with sparse LU solves of the quasi-definite KKT matrix
[[P + sigma I, A'], [A, -I/rho]]: another linear-algebra path than the
port's batched dense factors, run at a far tighter tolerance than the solves
it judges. A frozen copy of the repository's f64_oracle.py (its iteration,
adaptive-rho rule and stopping tests are those of the JAX package's
utils/oracle.py); qpbench/tests/test_frozen_copies.py holds the two to the
same answers. It imports numpy and scipy only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

RHO_MIN, RHO_MAX = 1e-3, 1e6


@dataclasses.dataclass
class OracleResult:
    x: np.ndarray
    z: np.ndarray
    y: np.ndarray
    status: int           # 1 = max-iters, 2 = admm fixed point, 3 = primal+dual
    iterations: int
    res_prim: float
    res_dual: float
    rho: float


def _inf_norm(v: np.ndarray) -> float:
    return float(np.abs(v).max()) if v.size else 0.0


def solve_qp_reference(P, q, A, l, u, *, max_iterations: int = 50_000,
                       eps_abs: float = 1e-9, eps_rel: float = 1e-9,
                       rho: float = 0.1, sigma: float = 1e-6,
                       alpha: float = 1.6, adaptive_rho: bool = True,
                       rho_factor: float = 5.0,
                       check_interval: int = 25) -> OracleResult:
    """Scalar f64 OSQP-ADMM from x = z = y = 0, refactored by splu when the
    candidate rho moves by more than ``rho_factor``."""
    P = sp.csc_matrix(P)
    A = sp.csc_matrix(A)
    q, l, u = (np.asarray(v, dtype=np.float64) for v in (q, l, u))
    n, m = q.size, l.size

    def factor(rho_val: float):
        K = sp.bmat([[P + sigma * sp.identity(n), A.T],
                     [A, -sp.identity(m) / rho_val]], format="csc")
        return spla.splu(K)

    x, z, y = np.zeros(n), np.zeros(m), np.zeros(m)
    eps_admm = min(eps_abs, eps_rel) * 1e-2
    rho_cand = rho
    lu = factor(rho)
    status, res_prim, res_dual = 1, np.inf, np.inf
    it = 0
    norm_q = _inf_norm(q)

    for it in range(1, max_iterations + 1):
        if adaptive_rho and (rho_cand * rho_factor < rho
                             or rho_cand > rho_factor * rho):
            rho = rho_cand
            lu = factor(rho)
        v = lu.solve(np.concatenate([sigma * x - q, z - y / rho]))
        xx = v[:n]
        zz = z + (v[n:] - y) / rho

        x_prev, z_prev = x, z
        x = alpha * xx + (1 - alpha) * x_prev
        z = np.clip(alpha * zz + (1 - alpha) * z_prev + y / rho, l, u)
        y = y + rho * (alpha * zz + (1 - alpha) * z_prev - z)

        if it % check_interval == 0:
            Ax, Px, ATy = A @ x, P @ x, A.T @ y
            res_prim = _inf_norm(Ax - z)
            res_dual = _inf_norm(Px + q + ATy)
            max_prim = max(_inf_norm(Ax), _inf_norm(z))
            max_dual = max(_inf_norm(Px), _inf_norm(ATy), norm_q)
            if adaptive_rho and res_dual * max_prim > 0:
                rho_cand = float(np.clip(
                    rho * np.sqrt((res_prim * max_dual) / (res_dual * max_prim)),
                    RHO_MIN, RHO_MAX))
            if (res_prim < eps_abs + eps_rel * max_prim
                    and res_dual < eps_abs + eps_rel * max_dual):
                status = 3
                break
            if (_inf_norm(x - x_prev) <= eps_admm
                    and _inf_norm(z - z_prev) <= eps_admm):
                status = 2
                break

    return OracleResult(x, z, y, status, it, res_prim, res_dual, rho)
