"""Problem and solution persistence (counterpart of the JAX package's
utils/checkpoint.py).

One ``.npz`` a object with the JAX package's keys, so a file written by
either package loads in the other: P, q, A, l, u for a problem; x, z, y and
the SolveInfo fields status, iterations, res_prim, res_dual, rho, objective
for a solution. A restored Solution warm-starts a new solve. Loading puts
the arrays on the CUDA card unless the caller names another device
(``device="cpu"``), each in the dtype it was saved in, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.problem import QP, default_device
from ..core.state import SolveInfo, Solution
from .interop import to_host

_QP_KEYS = ("P", "q", "A", "l", "u")
_INFO_KEYS = ("status", "iterations", "res_prim", "res_dual", "rho",
              "objective")


def save_qp(path: str, qp: QP) -> None:
    np.savez(path, **{k: to_host(t) for k, t in zip(_QP_KEYS, qp.tensors())})


def load_qp(path: str, device=None) -> QP:
    dev = default_device(device)
    with np.load(path) as d:
        return QP(*(torch.from_numpy(d[k]).to(dev) for k in _QP_KEYS))


def save_solution(path: str, sol: Solution) -> None:
    info = sol.info
    np.savez(path, x=to_host(sol.x), z=to_host(sol.z), y=to_host(sol.y),
             **{k: to_host(getattr(info, k)) for k in _INFO_KEYS})


def load_solution(path: str, device=None) -> Solution:
    dev = default_device(device)
    with np.load(path) as d:
        t = {k: torch.from_numpy(d[k]).to(dev) for k in d.files}
    info = SolveInfo(**{k: t[k] for k in _INFO_KEYS})
    return Solution(x=t["x"], z=t["z"], y=t["y"], info=info)
