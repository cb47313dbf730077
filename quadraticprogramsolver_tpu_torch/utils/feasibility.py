"""Host-side LP certificates for infeasibility and unboundedness claims
(counterpart of the JAX package's utils/feasibility.py, whose package
imports jax).

The solver flags lanes PRIMAL_INFEASIBLE / DUAL_INFEASIBLE from the OSQP
section 3.4 certificates (models/admm.py: _infeasibility_certificates).
These helpers check such a claim independently on the host, in float64,
with scipy's HiGHS LP solver, so a false positive fails loudly. They take
tensors (on any device) or numpy arrays and move them to the host.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize as spo
import scipy.sparse as sp

from .interop import to_host


def _f64(*arrays):
    return tuple(np.asarray(to_host(a), np.float64) for a in arrays)


def primal_feasible(A, l, u, tol: float = 1e-9) -> bool:
    """Does any x satisfy l <= Ax <= u? (A phase-1 LP, exact up to HiGHS's
    tolerance.) A lane flagged PRIMAL_INFEASIBLE is a false positive iff
    this returns True for its constraint data."""
    A, l, u = _f64(A, l, u)
    A = sp.csr_matrix(A)
    n = A.shape[1]
    res = spo.linprog(
        c=np.zeros(n),
        A_ub=sp.vstack([A[np.isfinite(u)], -A[np.isfinite(l)]], format="csr"),
        b_ub=np.concatenate([u[np.isfinite(u)] + tol,
                             -(l[np.isfinite(l)] - tol)]),
        bounds=[(None, None)] * n,
        method="highs",
    )
    # status 0 = optimal (feasible point found), 2 = infeasible.
    return res.status == 0


def dual_unbounded(P, q, A, l, u, tol: float = 1e-9) -> bool:
    """Does an unbounded descent ray exist? (OSQP's dual infeasibility.)

    The QP is unbounded below iff some dx has P dx = 0, q'dx < 0 and
    (A dx)_i in the recession cone of [l_i, u_i] (zero when both bounds are
    finite, <= 0 when only u_i is, >= 0 when only l_i is). Solved as an LP
    over dx in [-1, 1]^n; a lane flagged DUAL_INFEASIBLE is a false
    positive iff this returns False.
    """
    P, q, A, l, u = _f64(P, q, A, l, u)
    fin_l, fin_u = np.isfinite(l), np.isfinite(u)
    both = fin_l & fin_u
    only_u = fin_u & ~fin_l
    only_l = fin_l & ~fin_u
    A_eq = np.vstack([P, A[both]])
    b_eq = np.zeros(A_eq.shape[0])
    A_ub = np.vstack([A[only_u], -A[only_l]])
    b_ub = np.zeros(A_ub.shape[0])
    res = spo.linprog(
        c=q,
        A_ub=A_ub if A_ub.size else None,
        b_ub=b_ub if A_ub.size else None,
        A_eq=A_eq if A_eq.size else None,
        b_eq=b_eq if A_eq.size else None,
        bounds=[(-1.0, 1.0)] * q.size,
        method="highs",
    )
    return res.status == 0 and res.fun < -tol


def verify_status_flags(qp_arrays, status, statuses_to_check=(4, 5)) -> list:
    """Cross-check every lane flagged infeasible or unbounded against the LP
    oracle. Returns a list of (lane, status, reason) false positives.

    qp_arrays: (P, q, A, l, u) batched tensors or arrays; status: (B,) ints
    (4 = PRIMAL_INFEASIBLE, 5 = DUAL_INFEASIBLE).
    """
    P, q, A, l, u = (to_host(a) for a in qp_arrays)
    status = to_host(status)
    bad = []
    for i in np.where(np.isin(status, statuses_to_check))[0]:
        if status[i] == 4 and primal_feasible(A[i], l[i], u[i]):
            bad.append((int(i), 4, "flagged primal-infeasible but feasible"))
        if status[i] == 5 and not dual_unbounded(P[i], q[i], A[i], l[i], u[i]):
            bad.append((int(i), 5, "flagged dual-infeasible but bounded"))
    return bad
