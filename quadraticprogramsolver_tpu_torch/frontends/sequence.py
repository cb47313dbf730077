"""Warm-started QP sequences (MPC and tracking workloads), counterpart of
the JAX package's frontends/sequence.py.

The JAX package runs the time axis as one ``lax.scan``; torch has no scan,
so here it is a Python loop over the ticks that carries (x, z, y), and rho
or the prepared factor where asked, from each solve to the next, and stacks
every Solution tensor to (T, *B, ...) at the end. Each tick is one
:func:`~..models.admm.solve` on the tensors' device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.problem import QP
from ..core.settings import Settings
from ..core.state import SolveInfo, Solution
from ..models import admm


def warm_start_from(sol: Solution):
    """(x0, z0, y0) to warm-start the next solve of a sequence."""
    return sol.x, sol.z, sol.y


def _stack(sols) -> Solution:
    """Per-tick Solutions as one whose tensors carry a leading time axis."""
    def st(ts):
        return torch.stack(list(ts), dim=0)

    info = {}
    for f in dataclasses.fields(SolveInfo):
        vals = [getattr(s.info, f.name) for s in sols]
        if vals[0] is None:
            info[f.name] = None
        elif isinstance(vals[0], dict):
            info[f.name] = {k: st(v[k] for v in vals) for k in vals[0]}
        else:
            info[f.name] = st(vals)
    return Solution(x=st(s.x for s in sols), z=st(s.z for s in sols),
                    y=st(s.y for s in sols), info=SolveInfo(**info))


def _init(init, batch, n, m, dtype, device):
    kw = dict(dtype=dtype, device=device)
    if init is None:
        return (torch.zeros(batch + (n,), **kw), torch.zeros(batch + (m,), **kw),
                torch.zeros(batch + (m,), **kw))
    return tuple(torch.as_tensor(v, **kw) for v in init)


def solve_sequence(qp_seq: QP, settings: Settings = Settings(), init=None,
                   carry_rho: bool = True,
                   static_matrices: bool = False) -> Solution:
    """Solve a time sequence of QPs, each warm-started from its predecessor.

    ``qp_seq``'s tensors carry a leading time axis (P (T, *B, n, n), ...);
    the returned Solution's carry (T, *B, ...). ``carry_rho`` also carries
    each lane's adapted rho to the next tick. ``static_matrices=True``
    declares P and A constant along the time axis and factors once
    (:func:`~..models.admm.prepare` on tick 0): every tick then skips the
    factor and starts at the prepared rho (``carry_rho`` is ignored).
    """
    T = qp_seq.q.shape[0]
    batch = tuple(qp_seq.q.shape[1:-1])
    n, m = qp_seq.P.shape[-1], qp_seq.A.shape[-2]
    x, z, y = _init(init, batch, n, m, qp_seq.dtype, qp_seq.device)
    rho = torch.full(batch, settings.rho, dtype=qp_seq.dtype,
                     device=qp_seq.device)

    def tick(t):
        return QP(*(v[t] for v in qp_seq.tensors()))

    prepared = admm.prepare(tick(0), settings) if static_matrices else None
    sols = []
    for t in range(T):
        if prepared is not None:
            sol = admm.solve(tick(t), settings, x0=x, z0=z, y0=y,
                             prepared=prepared)
        else:
            sol = admm.solve(tick(t), settings, x0=x, z0=z, y0=y,
                             rho0=rho if carry_rho else None)
            rho = sol.info.rho
        x, z, y = sol.x, sol.z, sol.y
        sols.append(sol)
    return _stack(sols)


#: PyTorch runs eagerly; the alias keeps the JAX package's call sites.
solve_sequence_jit = solve_sequence


def solve_sequence_vectors(qp0: QP, q_seq, l_seq=None, u_seq=None,
                           settings: Settings = Settings(), init=None,
                           reuse_factor: bool = True) -> Solution:
    """A static-matrix sequence with per-tick vectors only: P and A are
    stored once at the fleet's shape (or without the batch axes, shared by
    the fleet); ``q_seq`` is (T, *B, n), ``l_seq``/``u_seq`` (T, *B, m) or
    None (qp0's bounds every tick). The factor is built once and every tick
    reuses it (``reuse_factor=False`` pays it a tick: the A/B baseline).
    (x, z, y) warm-start each tick from the last.
    """
    T = q_seq.shape[0]
    batch = qp0.batch_shape
    x, z, y = _init(init, batch, qp0.n, qp0.m, qp0.dtype, qp0.device)
    prepared = admm.prepare(qp0, settings) if reuse_factor else None
    sols = []
    for t in range(T):
        qp_t = QP(P=qp0.P, q=q_seq[t], A=qp0.A,
                  l=qp0.l if l_seq is None else l_seq[t],
                  u=qp0.u if u_seq is None else u_seq[t])
        sol = admm.solve(qp_t, settings, x0=x, z0=z, y0=y, prepared=prepared)
        x, z, y = sol.x, sol.z, sol.y
        sols.append(sol)
    return _stack(sols)


#: PyTorch runs eagerly; the alias keeps the JAX package's call sites.
solve_sequence_vectors_jit = solve_sequence_vectors
