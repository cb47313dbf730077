"""OSQP-style setup / update / solve front end with factor reuse
(counterpart of the JAX package's frontends/reuse.py).

:class:`CachedQPSolver` factors the KKT system once when it is built and
every :meth:`~CachedQPSolver.solve` skips the factor, while q, l and u
change freely between solves (OSQP's ``update_lin_cost``/``update_bounds``;
the reference's ProxQP factors at construction and reuses it). The work is
models/admm.py's :func:`~..models.admm.prepare` and ``solve(prepared=)``;
this class owns the handle, the vector updates and the warm start from the
previous solution. Its tensors stay where the problem's are.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.problem import QP
from ..core.settings import Settings
from ..core.state import Solution
from ..models import admm


class CachedQPSolver:
    """Factor once, solve many::

        solver = CachedQPSolver(qp, settings)     # setup: factors once
        sol = solver.solve()
        solver.update(q=new_q, l=new_l)           # no refactor
        sol = solver.solve(warm_start=True)       # factor and iterates reused

    P and A are fixed at construction (:meth:`refactor` replaces them and
    pays the factor again); q, l and u update freely. The solve runs at the
    prepared rho; with ``adaptive_rho`` a lane whose rho drifts refactors in
    the loop for that solve only (the prepared factor stays as it is).
    """

    def __init__(self, qp: QP, settings: Settings = Settings(), rho0=None,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "CachedQPSolver(mesh=...) shards the fleet over a device "
                "mesh, which the PyTorch port does not implement yet "
                "(ROADMAP.md Queue 1 item 7)")
        if settings.scaling_iters:
            raise ValueError(
                "CachedQPSolver does not support scaling_iters (the "
                "equilibration would be refit per solve, invalidating the "
                "cached factor); pre-scale the problem once instead")
        self._qp = qp
        self._settings = settings
        self._prepared = admm.prepare(qp, settings, rho0)
        self._last: Solution | None = None

    @property
    def qp(self) -> QP:
        return self._qp

    @property
    def prepared(self) -> admm.PreparedFactor:
        return self._prepared

    def _replaced(self, what: str, **new) -> dict:
        qp = self._qp
        upd = {}
        for name, value in new.items():
            if value is None:
                continue
            old = getattr(qp, name)
            value = torch.as_tensor(value, dtype=old.dtype, device=old.device)
            if value.shape != old.shape:
                raise ValueError(
                    f"{what}({name}): shape {tuple(value.shape)} != "
                    f"{tuple(old.shape)} (structure changes need a new "
                    "CachedQPSolver)")
            upd[name] = value
        return upd

    def update(self, q=None, l=None, u=None) -> None:
        """Replace cost and bound vectors without refactoring (shapes
        fixed); host input goes to the problem's device."""
        upd = self._replaced("update", q=q, l=l, u=u)
        if upd:
            self._qp = dataclasses.replace(self._qp, **upd)

    def refactor(self, P=None, A=None, rho0=None) -> None:
        """Replace P and/or A and factor again (OSQP's update_P/update_A).
        The warm start from the previous solve is kept."""
        upd = self._replaced("refactor", P=P, A=A)
        if upd:
            self._qp = dataclasses.replace(self._qp, **upd)
        self._prepared = admm.prepare(self._qp, self._settings, rho0)

    def solve(self, x0=None, z0=None, y0=None,
              warm_start: bool = False) -> Solution:
        """Solve with the cached factor. ``warm_start=True`` starts from the
        previous solve's (x, z, y); explicit ``x0``/``z0``/``y0`` win."""
        if warm_start and self._last is not None:
            x0 = self._last.x if x0 is None else x0
            z0 = self._last.z if z0 is None else z0
            y0 = self._last.y if y0 is None else y0
        sol = admm.solve(self._qp, self._settings, x0=x0, z0=z0, y0=y0,
                         prepared=self._prepared)
        self._last = sol
        return sol
