"""Solution polishing: masked active-set refinement with static shapes
(counterpart of the JAX package's models/polish.py).

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

Dense problems with m > n (where the m x m Schur complement would cost
O(m^3)) and sparse ones (which have no dense A) take ``polish_minres``:
batched matrix-free MINRES (models/kkt.py: ``_minres``) on the masked KKT
system, preconditioned by its block-Jacobi diagonal, ``polish_iterations``
corrections of the unregularized residual. It needs only the operator
protocol (matvec_P, matvec_A, matvec_At, diag_P), so on a SparseQP stored as
ELL every product is the ELL kernel.
"""

from __future__ import annotations

import torch

from ..core.settings import Settings
from ..ops.linalg import (add_scaled_identity, inf_norm, mm, mv, mv_t,
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


def _accept(qp, x, y, px, pn):
    """(x, y) replaced by (px, pn) on the lanes where the KKT error drops
    and px is finite."""
    accept = ((_kkt_error(qp, px, pn) < _kkt_error(qp, x, y))
              & px.isfinite().all(-1))
    return (torch.where(accept[..., None], px, x),
            torch.where(accept[..., None], pn, y))


def polish_minres(qp, settings: Settings, x, z, y, rho):
    """Matrix-free masked-KKT polish by batched MINRES.

    Solves [[P + delta I, E'], [E, -R]] [px; pn] = [-q; g] with E = diag(active)
    A applied through the operator protocol, preconditioned by the block
    Jacobi diagonal [1/(diag P + delta), 1/r]; each of ``polish_iterations``
    sweeps runs MINRES (relative tolerance ``polish_eps``, at most
    ``polish_max_krylov`` steps) on the residual of the unregularized
    system, removing the O(delta) bias of the regularized one.
    """
    from .kkt import _minres

    dt, dev = qp.dtype, qp.device
    n = qp.n
    delta = settings.delta
    active, g = _active_set(qp, settings, x, z, y)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    r_diag = torch.where(active, one * delta, one)

    def apply_K(v):
        v1, v2 = v[..., :n], v[..., n:]
        top = (qp.matvec_P(v1) + delta * v1
               + qp.matvec_At(torch.where(active, v2, zero)))
        bot = torch.where(active, qp.matvec_A(v1), zero) - r_diag * v2
        return torch.cat([top, bot], dim=-1)

    def apply_K_exact(v):
        # The unregularized target [[P, E'], [E, 0]] on the active rows,
        # nu = 0 elsewhere (delta appears only in the solver's operator).
        v1, v2 = v[..., :n], v[..., n:]
        top = qp.matvec_P(v1) + qp.matvec_At(torch.where(active, v2, zero))
        bot = (torch.where(active, qp.matvec_A(v1), zero)
               - torch.where(active, zero, v2))
        return torch.cat([top, bot], dim=-1)

    d1 = qp.diag_P() + delta
    d1_inv = torch.where(d1 > 0, 1.0 / d1, one).expand(x.shape)

    def precond(v):
        return torch.cat([d1_inv * v[..., :n], v[..., n:] / r_diag], dim=-1)

    b = torch.cat([-qp.q + torch.zeros_like(x), g], dim=-1)
    v = torch.cat([x, torch.where(active, y, zero)], dim=-1)
    for _ in range(max(1, settings.polish_iterations)):
        r = b - apply_K_exact(v)
        v = v + _minres(apply_K, precond, r, torch.zeros_like(b),
                        abs_tol=0.0, rel_tol=settings.polish_eps,
                        max_iterations=settings.polish_max_krylov)
    return _accept(qp, x, y, v[..., :n], v[..., n:])


def polish(qp, settings: Settings, x, z, y, rho):
    """Refine (x, y) on the active set; returns (x, y) with per-lane
    acceptance. The dense Schur path for m <= n, :func:`polish_minres`
    otherwise (see the module docstring)."""
    if not qp.is_dense or qp.m > qp.n:
        return polish_minres(qp, settings, x, z, y, rho)
    dt, dev = qp.dtype, qp.device
    delta = settings.delta
    active, g = _active_set(qp, settings, x, z, y)
    zero = torch.zeros((), dtype=dt, device=dev)
    E = torch.where(active[..., None], qp.A, zero)
    one = torch.ones((), dtype=dt, device=dev)
    r_diag = torch.where(active, one * delta, one)

    # Schur-complement direct solve of [[H, E'], [E, -R]].
    H_inv = spd_inverse(add_scaled_identity(sym(qp.P), delta))
    EHiEt = mm(mm(E, H_inv), E.transpose(-1, -2))
    S = sym(EHiEt) + r_diag[..., None] * torch.eye(qp.m, dtype=dt, device=dev)
    S_inv = spd_inverse(S)

    def kkt_solve(rx, rn):
        w = mv(H_inv, rx)
        dn = mv(S_inv, mv(E, w) - rn)
        dx = w - mv(H_inv, mv_t(E, dn))
        return dx, dn

    def kkt_apply_exact(px, pn):
        # The unregularized target [[P, E'], [E, 0]] on the active rows,
        # nu = 0 elsewhere: refinement against it removes the O(delta) bias.
        return (mv(qp.P, px) + mv_t(E, pn),
                mv(E, px) - torch.where(active, zero, pn))

    bx, bn = -qp.q, g
    px, pn = kkt_solve(bx, bn)
    for _ in range(max(1, settings.polish_iterations) - 1):
        ax, an = kkt_apply_exact(px, pn)
        dx, dn = kkt_solve(bx - ax, bn - an)
        px, pn = px + dx, pn + dn

    return _accept(qp, x, y, px, pn)
