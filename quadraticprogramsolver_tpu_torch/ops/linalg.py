"""Small batched linear-algebra primitives (torch ops on any device)."""

from __future__ import annotations

import torch


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched M @ v: (*B, r, c) x (*B, c) -> (*B, r)."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def inf_norm(v: torch.Tensor) -> torch.Tensor:
    """Batched infinity norm over the last axis; 0 for empty vectors."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return v.abs().amax(-1)


def add_scaled_identity(M: torch.Tensor, s) -> torch.Tensor:
    """M + s*I on the last two axes (s a scalar)."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return M + s * eye


def spd_solve(M: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Batched SPD multi-RHS solve M X = R by Cholesky (the unfused path)."""
    L = torch.linalg.cholesky(M)
    return torch.cholesky_solve(R, L)


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse by Cholesky, symmetrized."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand_as(M)
    inv = spd_solve(M, eye)
    return 0.5 * (inv + inv.transpose(-1, -2))
