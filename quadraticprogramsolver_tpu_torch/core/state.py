"""Solver state and result containers (batched tensors, one lane per QP)."""

from __future__ import annotations

import dataclasses
import enum

import torch


class Status(enum.IntEnum):
    """Per-instance convergence flag (values match the JAX package)."""

    RUNNING = 0
    MAX_ITERATIONS = 1
    SOLVED_ADMM = 2
    SOLVED = 3
    PRIMAL_INFEASIBLE = 4
    DUAL_INFEASIBLE = 5


@dataclasses.dataclass
class SolverState:
    """Batched ADMM iterate; every per-lane tensor has batch shape *B.

    x: (*B, n); z, y: (*B, m); rho, rho_cand, res_prim, res_dual: (*B,);
    status, iterations: (*B,) int32; iteration: host int (global counter);
    kkt_cache: backend dict; products: {"Px", "Ax", "ATy"} at the current
    iterate when certificates are on, else None.
    """

    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    rho: torch.Tensor
    rho_cand: torch.Tensor
    status: torch.Tensor
    iterations: torch.Tensor
    res_prim: torch.Tensor
    res_dual: torch.Tensor
    iteration: int
    kkt_cache: dict
    products: dict | None = None


@dataclasses.dataclass
class SolveInfo:
    """Per-instance solve diagnostics (batched)."""

    status: torch.Tensor
    iterations: torch.Tensor
    res_prim: torch.Tensor
    res_dual: torch.Tensor
    rho: torch.Tensor
    objective: torch.Tensor


@dataclasses.dataclass
class Solution:
    """Full primal/dual solution of a batched solve."""

    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    info: SolveInfo
