"""Small batched linear-algebra primitives (torch ops on any device)."""

from __future__ import annotations

import contextlib
import math
import threading

import torch

from ..core.settings import DOT_PRECISIONS


#: The open FP32 scopes of the process, and the settings the outermost one
#: found (guarded by the lock: only the outermost exit restores them).
_scope_lock = threading.Lock()
_scope = {"depth": 0, "saved": None}


def _read_product_settings():
    """The caller's float32 product settings: the legacy precision and, on a
    torch with per-backend precisions, the cuda and mkldnn matmul ones."""
    try:
        precision = torch.get_float32_matmul_precision()
    except RuntimeError:
        # The caller mixed the legacy and the per-backend settings, which
        # torch refuses to read as one: the per-backend ones come back below,
        # the legacy one is TF32's flag where that still reads, else its
        # default (only the per-backend API was used).
        try:
            precision = "high" if torch.backends.cuda.matmul.allow_tf32 else "highest"
        except RuntimeError:
            precision = "highest"
    backends = [m for m in (getattr(torch.backends.cuda, "matmul", None),
                            getattr(torch.backends.mkldnn, "matmul", None))
                if hasattr(m, "fp32_precision")]
    return precision, [(m, m.fp32_precision) for m in backends]


@contextlib.contextmanager
def fp32_products():
    """Full-FP32 torch products inside the block, whatever the caller set:
    the float32 matmul precision "highest", which also turns cuBLAS's TF32
    off (``torch.backends.cuda.matmul.allow_tf32`` reads the same setting).
    On exit, also when the block raises, the caller's settings come back
    exactly: the precision and, on a torch with per-backend precisions, the
    cuda and mkldnn matmul ones. The JAX package's counterpart is
    ``jax.default_matmul_precision`` around each solve (models/admm.py:669,
    843; "highest" in models/proxqp.py:258, 295). The hand-written kernels
    compute in FP32 either way; this scopes the products torch computes
    around them.

    Torch's settings are global to the process, where JAX's scope is local
    to a thread. Scopes nest and may overlap across threads: the outermost
    entry saves the caller's settings and the last exit restores them, so
    concurrent solves all run in FP32. While any scope is open, code of
    other threads outside it also sees "highest", and a setting another
    thread changes meanwhile is overwritten at the last exit.
    """
    with _scope_lock:
        if _scope["depth"] == 0:
            _scope["saved"] = _read_product_settings()
            torch.set_float32_matmul_precision("highest")
        _scope["depth"] += 1
    try:
        yield
    finally:
        with _scope_lock:
            _scope["depth"] -= 1
            if _scope["depth"] == 0:
                precision, backends = _scope["saved"]
                torch.set_float32_matmul_precision(precision)
                for m, value in backends:
                    m.fp32_precision = value


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched M @ v: (*B, r, c) x (*B, c) -> (*B, r)."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def matvec_t(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched M' @ v: (*B, r, c) x (*B, r) -> (*B, c)."""
    return torch.matmul(v.unsqueeze(-2), M).squeeze(-2)


def sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def spsd_sqrt(A: torch.Tensor, rank_tol: float = 1e-10) -> torch.Tensor:
    """Batched M with M'M = A for a (possibly singular) symmetric PSD A.

    With A = V diag(w) V', M = diag(sqrt(w)) V' after eigenvalues below
    rank_tol * max|w| are clipped to zero (the numerical-rank cutoff of the
    reference's CalcSPSDSquareRoot, SPSDMatSquareRoot.jl:63-118). Returns
    (*B, n, n); rows beyond the rank are zero.
    """
    w, V = torch.linalg.eigh(sym(A))
    w_max = w.abs().amax(-1, keepdim=True)
    w = torch.where(w > rank_tol * w_max, w, torch.zeros_like(w))
    return torch.sqrt(w)[..., None] * V.transpose(-1, -2)


#: The code of each chunk product precision in the kernels' C entry points
#: (csrc/common.cuh: Prec).
PRECISIONS = {p: i for i, p in enumerate(DOT_PRECISIONS)}


def resolve_precision(precision: str, dtype) -> str:
    """The bf16 precisions apply to float32 only: any other dtype runs its
    products in full, as the JAX package's float64 solve does."""
    return precision if dtype == torch.float32 else "highest"


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (nearest even), in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def bf16_split(t: torch.Tensor):
    """The two bfloat16 halves of t: hi = bf16(t), lo = bf16(t - hi), each
    rounded to nearest even (what the kernels compute in registers)."""
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.to(t.dtype)).to(torch.bfloat16)


def dot_operand(M: torch.Tensor, precision: str) -> tuple:
    """M as a product at a (resolved) precision reads it, in M's dtype:
    (M,) at "highest", (bf16(M),) at "default", its halves at "high"."""
    if precision == "default":
        return (bf16_round(M),)
    if precision == "high":
        return tuple(h.to(M.dtype) for h in bf16_split(M))
    return (M,)


def matvec_at(op: tuple, v: torch.Tensor, precision: str) -> torch.Tensor:
    """M @ v at a (resolved) precision, M given as :func:`dot_operand` made
    it: "default" rounds v to bf16 too; "high" is the bf16x3 sum
    (Mh vh + Mh vl) + Ml vh, in the JAX kernel's order."""
    if precision == "default":
        return matvec(op[0], bf16_round(v))
    if precision == "high":
        vh, vl = (h.to(v.dtype) for h in bf16_split(v))
        return matvec(op[0], vh) + matvec(op[0], vl) + matvec(op[1], vh)
    return matvec(op[0], v)


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
