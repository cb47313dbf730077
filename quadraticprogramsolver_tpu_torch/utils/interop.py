"""Carry problems, settings, warm starts and solutions between the JAX
package and the port, through numpy and plain dicts only (nothing here
imports jax)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.problem import (QP, ProxQPProblem, default_device, make_proxqp,
                            make_qp)
from ..core.settings import KKTBackendKind, ProxQPSettings, Settings
from ..core.state import Solution


def to_host(v) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array on the host."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def qp_from_numpy(P, q, A, l, u, *, device="cuda", dtype=torch.float64) -> QP:
    """The port's QP from numpy arrays (e.g. ``np.asarray`` of a JAX QP)."""
    return make_qp(*(np.asarray(v) for v in (P, q, A, l, u)),
                   dtype=dtype, device=device)


def _check_keys(cls, d: dict) -> None:
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - fields)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {unknown}")


def settings_from_dict(d: dict) -> Settings:
    """The port's Settings from ``dataclasses.asdict(jax_settings)``.

    Raises ValueError on a key the port's Settings does not have, and the
    validator's ValueError on a value it rejects.
    """
    _check_keys(Settings, d)
    kw = dict(d)
    if "kkt_backend" in kw:
        kind = kw["kkt_backend"]
        kw["kkt_backend"] = KKTBackendKind(getattr(kind, "value", kind))
    return Settings(**kw)


def proxqp_from_numpy(P, q, A, b, C, d, *, device="cuda",
                      dtype=torch.float64) -> ProxQPProblem:
    """The port's ProxQPProblem from numpy arrays (e.g. ``np.asarray`` of
    each field of a JAX ProxQPProblem)."""
    return make_proxqp(*(np.asarray(v) for v in (P, q, A, b, C, d)),
                       dtype=dtype, device=device)


def prox_settings_from_dict(d: dict) -> ProxQPSettings:
    """The port's ProxQPSettings from ``dataclasses.asdict(jax_settings)``
    (ValueError on an unknown key or a rejected value)."""
    _check_keys(ProxQPSettings, d)
    return ProxQPSettings(**d)


def warm_start_from_numpy(x0=None, z0=None, y0=None, rho0=None, *,
                          device="cuda", dtype=torch.float64):
    """(x0, z0, y0, rho0) as tensors; None passes through."""
    def conv(v):
        if v is None:
            return None
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)

    dev = default_device(device)
    return tuple(conv(v) for v in (x0, z0, y0, rho0))


def _info_fields(info, out: dict) -> dict:
    """Every field of an info dataclass that is set; the history dict as
    ``history_<key>``."""
    for f in dataclasses.fields(info):
        v = getattr(info, f.name)
        if isinstance(v, dict):
            out.update({f"{f.name}_{k}": t for k, t in v.items()})
        elif v is not None:
            out[f.name] = v
    return {k: to_host(v) for k, v in out.items()}


def solution_to_numpy(sol: Solution) -> dict:
    """A port Solution as a dict of numpy arrays (x, z, y and every
    SolveInfo field that is set)."""
    return _info_fields(sol.info, {k: getattr(sol, k) for k in ("x", "z", "y")})


def prox_solution_to_numpy(sol) -> dict:
    """A port ProxQPSolution as a dict of numpy arrays (x, s, y, z and every
    ProxQPInfo field that is set)."""
    return _info_fields(sol.info, {k: getattr(sol, k) for k in ("x", "s", "y", "z")})
