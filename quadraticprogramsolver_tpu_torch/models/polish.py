"""Solution polishing: masked active-set refinement with static shapes
(counterpart of the JAX package's models/polish.py, its dense Schur path).

Rows of A are not sliced out of the KKT system; inactive rows are masked
instead: E = diag(active) A, their dual equations become nu_i = 0, and

    [[P + delta I,  E'], [E,  -R]] [x; nu] = [-q; g],
    R = diag(active ? delta : 1),  g = l or u on the active rows,

has the reduced system's solution on the active rows and nu = 0 elsewhere.
Infinite bounds never bind.

The dense m <= n path solves it by the Schur complement on the SPD block:
H^{-1} = (sym(P) + delta I)^{-1} and S^{-1} = (E H^{-1} E' + R)^{-1}, both
through ``ops/linalg.py: spd_inverse`` (the blocked Gauss-Jordan sweep
around the pivot kernel at 128-multiple sizes on fleets of at least 4, else
Cholesky), then ``polish_iterations - 1`` refinement passes against the
unregularized operator. Acceptance is per lane: the polished (x, y) replace
the ADMM ones only where the KKT error drops and x is finite.

The JAX package sends m > n and sparse problems to a matrix-free MINRES
polish (``polish_minres``), which needs the KKT_MINRES machinery this port
does not have yet; that branch raises.
"""

from __future__ import annotations

import torch

from ..core.settings import Settings
from ..ops.linalg import (add_scaled_identity, inf_norm, matvec, matvec_t,
                          spd_inverse, sym)


def _kkt_error(qp, x, y):
    """max(dual residual, bound violation): the acceptance metric."""
    Ax = qp.matvec_A(x)
    res_dual = inf_norm(qp.matvec_P(x) + qp.q + qp.matvec_At(y))
    viol = inf_norm(Ax - torch.minimum(torch.maximum(Ax, qp.l), qp.u))
    return torch.maximum(res_dual, viol)


def _active_set(qp, settings: Settings, x, z, y):
    """Active rows from the dual's sign AND the split iterate's distance to
    the bound (within 10 max(res_prim, eps_abs) (1 + |bound|)): the sign
    alone tags every row whose dual carries noise at a loose solve.
    Infinite bounds never bind."""
    rp = inf_norm(qp.matvec_A(x) - z)[..., None]
    c = 10.0 * torch.clamp(rp, min=settings.eps_abs)
    low_active = ((y < 0) & qp.l.isfinite()
                  & (z - qp.l <= c * (1.0 + qp.l.abs())))
    up_active = ((y > 0) & qp.u.isfinite()
                 & (qp.u - z <= c * (1.0 + qp.u.abs())))
    active = low_active | up_active
    zero = torch.zeros((), dtype=qp.dtype, device=qp.device)
    g = torch.where(low_active, qp.l, zero) + torch.where(up_active, qp.u, zero)
    return active, g


def polish(qp, settings: Settings, x, z, y, rho):
    """Refine (x, y) on the active set; returns (x, y) with per-lane
    acceptance. Dense QPs with m <= n only (see the module docstring)."""
    if not qp.is_dense or qp.m > qp.n:
        raise NotImplementedError(
            "polish of a sparse QP or of a dense one with m > n (here "
            f"{'sparse' if not qp.is_dense else f'm={qp.m} > n={qp.n}'}) "
            "runs the matrix-free MINRES polish of the KKT_MINRES backend, "
            "which the PyTorch port does not implement yet (ROADMAP.md "
            "Queue 1 item 4)")
    dt, dev = qp.dtype, qp.device
    delta = settings.delta
    active, g = _active_set(qp, settings, x, z, y)
    zero = torch.zeros((), dtype=dt, device=dev)
    E = torch.where(active[..., None], qp.A, zero)
    one = torch.ones((), dtype=dt, device=dev)
    r_diag = torch.where(active, one * delta, one)

    # Schur-complement direct solve of [[H, E'], [E, -R]].
    H_inv = spd_inverse(add_scaled_identity(sym(qp.P), delta))
    EHiEt = torch.matmul(torch.matmul(E, H_inv), E.transpose(-1, -2))
    S = sym(EHiEt) + r_diag[..., None] * torch.eye(qp.m, dtype=dt, device=dev)
    S_inv = spd_inverse(S)

    def kkt_solve(rx, rn):
        w = matvec(H_inv, rx)
        dn = matvec(S_inv, matvec(E, w) - rn)
        dx = w - matvec(H_inv, matvec_t(E, dn))
        return dx, dn

    def kkt_apply_exact(px, pn):
        # The unregularized target [[P, E'], [E, 0]] on the active rows,
        # nu = 0 elsewhere: refinement against it removes the O(delta) bias.
        return (matvec(qp.P, px) + matvec_t(E, pn),
                matvec(E, px) - torch.where(active, zero, pn))

    bx, bn = -qp.q, g
    px, pn = kkt_solve(bx, bn)
    for _ in range(max(1, settings.polish_iterations) - 1):
        ax, an = kkt_apply_exact(px, pn)
        dx, dn = kkt_solve(bx - ax, bn - an)
        px, pn = px + dx, pn + dn

    err_before = _kkt_error(qp, x, y)
    err_after = _kkt_error(qp, px, pn)
    accept = (err_after < err_before) & px.isfinite().all(-1)
    x_out = torch.where(accept[..., None], px, x)
    y_out = torch.where(accept[..., None], pn, y)
    return x_out, y_out
