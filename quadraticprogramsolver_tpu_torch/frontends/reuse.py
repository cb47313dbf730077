"""OSQP-style setup / update / solve front end with factor reuse
(counterpart of the JAX package's frontends/reuse.py).

:class:`CachedQPSolver` factors the KKT system once when it is built and
every :meth:`~CachedQPSolver.solve` skips the factor, while q, l and u
change freely between solves (OSQP's ``update_lin_cost``/``update_bounds``;
the reference's ProxQP factors at construction and reuses it). The work is
models/admm.py's :func:`~..models.admm.prepare` and ``solve(prepared=)``;
this class owns the handle, the vector updates and the warm start from the
previous solution. Its tensors stay where the problem's are; with ``mesh=``
each rank of a fleet keeps its lanes' share (parallel/mesh.py).
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
        """``mesh``: a DeviceMesh with a "qp" axis (parallel/mesh.py) to split
        the fleet over, as the JAX package's ``mesh=`` shards it: every rank
        passes the whole fleet, keeps its slice of the lanes and the factor
        of that slice, takes fleet-wide vectors in :meth:`update` and
        :meth:`solve`, and gets the whole Solution back."""
        if settings.scaling_iters:
            raise ValueError(
                "CachedQPSolver does not support scaling_iters (the "
                "equilibration would be refit per solve, invalidating the "
                "cached factor); pre-scale the problem once instead")
        self._mesh = mesh
        self._lanes = None
        if mesh is not None:
            from ..parallel import mesh as mesh_mod

            r, _, _ = mesh_mod.axis(mesh, mesh_mod.BATCH_AXIS)
            qp = mesh_mod.shard_fleet(qp, mesh)
            per = qp.batch_shape[0]
            self._lanes = slice(r * per, (r + 1) * per)
        self._qp = qp
        self._settings = settings
        self._prepared = admm.prepare(qp, settings, rho0)
        self._last: Solution | None = None

    @property
    def qp(self) -> QP:
        """The problem solved here: with a mesh, this rank's shard."""
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
            value = self._local(
                torch.as_tensor(value, dtype=old.dtype, device=old.device))
            if value.shape != old.shape:
                raise ValueError(
                    f"{what}({name}): shape {tuple(value.shape)} != "
                    f"{tuple(old.shape)} (structure changes need a new "
                    "CachedQPSolver)")
            upd[name] = value
        return upd

    def _local(self, v):
        """A fleet-wide tensor's lanes of this rank (all of it without a
        mesh)."""
        if v is None or self._lanes is None:
            return v
        return torch.as_tensor(v)[self._lanes].to(self._qp.device)

    def update(self, q=None, l=None, u=None) -> None:
        """Replace cost and bound vectors without refactoring (shapes
        fixed); host input goes to the problem's device. With a mesh the
        vectors are fleet-wide and each rank keeps its lanes."""
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
        if self._mesh is None:
            sol = admm.solve(self._qp, self._settings, x0=x0, z0=z0, y0=y0,
                             prepared=self._prepared)
        else:
            from ..core.lockstep import lockstep
            from ..parallel.mesh import BATCH_AXIS, gather_lanes

            group = self._mesh.get_group(BATCH_AXIS)
            with lockstep(group):
                sol = admm.solve(self._qp, self._settings,
                                 x0=self._local(x0), z0=self._local(z0),
                                 y0=self._local(y0), prepared=self._prepared)
            sol = gather_lanes(sol, group)
        self._last = sol
        return sol
