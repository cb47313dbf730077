"""Constrained least squares (counterpart of the JAX package's
frontends/lsq.py)

    min 0.5 ||Ax - b||^2   s.t.   Bx <= c,  Dx = e,

lowered onto either solver family: the box form (P = A'A, q = -A'b, rows
[D; B] with l = u = e on the equalities and (-inf, c] on the inequalities)
for the OSQP-ADMM solver, or the split form (A_eq = D, b_eq = e, C = B,
d = c) for the prox-ALM solver. Every array may carry leading batch axes.
Tensors keep their device; host (numpy) input goes to the CUDA card unless
``device`` names another.
"""

from __future__ import annotations

import torch

from ..core.problem import QP, ProxQPProblem, _as_tensors
from ..core.settings import ProxQPSettings, Settings
from ..models import admm, proxqp
from ..ops.linalg import matvec_t


def _normal_objective(A, b):
    """P = A'A (PSD), q = -A'b for 0.5||Ax - b||^2 (the constant dropped)."""
    return torch.matmul(A.transpose(-1, -2), A), -matvec_t(A, b)


def _empty_like(A, rows):
    batch, n = tuple(A.shape[:-2]), A.shape[-1]
    kw = dict(dtype=A.dtype, device=A.device)
    return torch.zeros(batch + (rows, n), **kw), torch.zeros(batch + (rows,), **kw)


def _check_pairs(B, c, D, e):
    if (B is None) != (c is None):
        raise ValueError("B and c must be provided together (Bx <= c)")
    if (D is None) != (e is None):
        raise ValueError("D and e must be provided together (Dx = e)")


def _lowered(A, b, B, c, D, e, device):
    _check_pairs(B, c, D, e)
    A, b = _as_tensors((A, b), device=device)
    P, q = _normal_objective(A, b)
    if B is None:
        B, c = _empty_like(A, 0)
    if D is None:
        D, e = _empty_like(A, 0)
    B, c, D, e = _as_tensors((B, c, D, e), dtype=A.dtype, device=A.device)
    return P, q, B, c, D, e


def lsq_to_qp(A, b, B=None, c=None, D=None, e=None, device=None) -> QP:
    """Lower the constrained LSQ onto the box form."""
    P, q, B, c, D, e = _lowered(A, b, B, c, D, e, device)
    G = torch.cat([D, B], dim=-2)
    l = torch.cat([e, torch.full_like(c, -float("inf"))], dim=-1)
    u = torch.cat([e, c], dim=-1)
    return QP(P=P, q=q, A=G, l=l, u=u)


def lsq_to_proxqp(A, b, B=None, c=None, D=None, e=None,
                  device=None) -> ProxQPProblem:
    """Lower the constrained LSQ onto the equality/inequality split form."""
    P, q, B, c, D, e = _lowered(A, b, B, c, D, e, device)
    return ProxQPProblem(P=P, q=q, A=D, b=e, C=B, d=c)


def solve_lsq(A, b, B=None, c=None, D=None, e=None,
              settings: Settings = Settings(), x0=None, device=None):
    """Solve the constrained LSQ with the OSQP-ADMM solver."""
    return admm.solve(lsq_to_qp(A, b, B, c, D, e, device), settings, x0)


def solve_lsq_proxqp(A, b, B=None, c=None, D=None, e=None,
                     settings: ProxQPSettings = ProxQPSettings(),
                     device=None):
    """Solve the constrained LSQ with the prox-ALM solver."""
    return proxqp.solve(lsq_to_proxqp(A, b, B, c, D, e, device), settings)
