"""Carry problems, settings, warm starts and solutions between the JAX
package and the port, through numpy and plain dicts only (nothing here
imports jax)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.problem import QP, make_qp
from ..core.settings import KKTBackendKind, Settings
from ..core.state import Solution


def qp_from_numpy(P, q, A, l, u, *, device="cpu", dtype=torch.float64) -> QP:
    """The port's QP from numpy arrays (e.g. ``np.asarray`` of a JAX QP)."""
    return make_qp(*(np.asarray(v) for v in (P, q, A, l, u)),
                   dtype=dtype, device=device)


def settings_from_dict(d: dict) -> Settings:
    """The port's Settings from ``dataclasses.asdict(jax_settings)``.

    Raises ValueError on a key the port's Settings does not have, and
    NotImplementedError (from the validator) on a knob the port rejects.
    """
    fields = {f.name for f in dataclasses.fields(Settings)}
    unknown = sorted(set(d) - fields)
    if unknown:
        raise ValueError(f"unknown Settings keys: {unknown}")
    kw = dict(d)
    if "kkt_backend" in kw:
        kind = kw["kkt_backend"]
        kw["kkt_backend"] = KKTBackendKind(getattr(kind, "value", kind))
    return Settings(**kw)


def warm_start_from_numpy(x0=None, z0=None, y0=None, rho0=None, *,
                          device="cpu", dtype=torch.float64):
    """(x0, z0, y0, rho0) as tensors; None passes through."""
    def conv(v):
        if v is None:
            return None
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

    return tuple(conv(v) for v in (x0, z0, y0, rho0))


def solution_to_numpy(sol: Solution) -> dict:
    """A port Solution as a dict of numpy arrays (x, z, y and every
    SolveInfo field)."""
    out = {k: getattr(sol, k) for k in ("x", "z", "y")}
    for f in dataclasses.fields(sol.info):
        out[f.name] = getattr(sol.info, f.name)
    return {k: v.detach().cpu().numpy() for k, v in out.items()}
