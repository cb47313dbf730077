"""Small batched linear-algebra primitives (torch ops on any device)."""

from __future__ import annotations

import math

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


def kernel_dtype_ok(dtype, device) -> bool:
    """The CUDA kernels take float32; the plain versions that stand in for
    them on the CPU also take float64 (so f64 parity runs the same path)."""
    if dtype == torch.float32:
        return True
    return dtype == torch.float64 and torch.device(device).type == "cpu"


def sweep_ok(n: int, batch: int, dtype, device) -> bool:
    """The JAX package's rule for the blocked Gauss-Jordan sweep (its
    ``spd_inverse``/``spd_solve`` on the accelerator): a dtype the kernels
    take, n a nonzero multiple of 128 and a flat batch of at least 4
    matrices. Static (shape, dtype, device): on CUDA the sweep launches the
    pivot kernel or raises, on the CPU it runs the kernel's plain version."""
    return kernel_dtype_ok(dtype, device) and n % 128 == 0 and n > 0 and batch >= 4


def _sweep_ok(M: torch.Tensor) -> bool:
    return sweep_ok(M.shape[-1], math.prod(M.shape[:-2]), M.dtype, M.device)


def spd_solve(M: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Batched SPD multi-RHS solve M X = R: the Gauss-Jordan sweep around
    the pivot kernel where :func:`sweep_ok` holds, else Cholesky."""
    if _sweep_ok(M):
        from .spd_kernels import gj_solve_sweep

        return gj_solve_sweep(M, R)
    L = torch.linalg.cholesky(M)
    return torch.cholesky_solve(R, L)


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse: the blocked Gauss-Jordan sweep around the pivot
    kernel where :func:`sweep_ok` holds (symmetric to rounding), else
    Cholesky, symmetrized."""
    if _sweep_ok(M):
        from .spd_kernels import spd_inverse_sweep_fused

        return spd_inverse_sweep_fused(M)
    return cholesky_inverse(M)


def cholesky_inverse(M: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse by Cholesky, symmetrized."""
    L = torch.linalg.cholesky(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand_as(M)
    inv = torch.cholesky_solve(eye, L)
    return 0.5 * (inv + inv.transpose(-1, -2))
