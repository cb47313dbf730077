"""Host-side float64 KKT optimality check of a box-constrained QP.

A numpy/scipy copy of the JAX package's ``utils/oracle.py: KKTReport,
kkt_optimality`` (that module's package imports jax): the host-side audit of
a solve that is too large for a reference re-solve, such as the large sparse
path. A solution passing it at tolerance eps is optimal whichever solver
produced it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


def _inf_norm(v: np.ndarray) -> float:
    return float(np.abs(v).max()) if v.size else 0.0


@dataclasses.dataclass
class KKTReport:
    res_prim: float        # ||clip(Ax,l,u) - Ax||_inf  (bound violation)
    res_dual: float        # ||Px + q + A'y||_inf
    res_comp: float        # complementary-slackness violation
    res_z: float           # ||Ax - z||_inf

    def optimal(self, eps: float) -> bool:
        return max(self.res_prim, self.res_dual, self.res_comp) <= eps


def kkt_optimality(P, q, A, l, u, x, z=None, y=None) -> KKTReport:
    """Check the KKT conditions of `min 0.5x'Px+q'x s.t. l<=Ax<=u` at
    (x, z, y).

    Stationarity: Px + q + A'y = 0. Primal feasibility: l <= Ax <= u.
    Complementarity: y+ (u - Ax) = 0 and y- (Ax - l) = 0 elementwise (y > 0
    only at the upper bound, y < 0 only at the lower).
    """
    P = sp.csc_matrix(P)
    A = sp.csc_matrix(A)
    q, l, u = (np.asarray(v, dtype=np.float64) for v in (q, l, u))
    x = np.asarray(x, dtype=np.float64)
    Ax = A @ x
    res_prim = _inf_norm(Ax - np.clip(Ax, l, u))
    if y is None:
        return KKTReport(res_prim, np.inf, np.inf, np.inf)
    y = np.asarray(y, dtype=np.float64)
    res_dual = _inf_norm(P @ x + q + A.T @ y)
    y_pos = np.maximum(y, 0.0)
    y_neg = np.minimum(y, 0.0)
    # On infinite-bound rows the dual must simply have the right sign; a
    # wrong-sign dual there is a violation measured by |y| itself.
    gap_u = np.where(np.isfinite(u), u - Ax, 0.0)   # 0 avoids 0*inf=nan
    gap_l = np.where(np.isfinite(l), Ax - l, 0.0)
    comp_u = np.where(np.isfinite(u), y_pos * gap_u, y_pos)
    comp_l = np.where(np.isfinite(l), -y_neg * gap_l, -y_neg)
    comp = max(
        _inf_norm(np.where(y_pos > 0, comp_u, 0.0)),
        _inf_norm(np.where(y_neg < 0, comp_l, 0.0)),
    )
    res_z = _inf_norm(Ax - z) if z is not None else np.inf
    return KKTReport(res_prim, res_dual, comp, res_z)
