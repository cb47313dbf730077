"""Small batched linear-algebra primitives (torch ops on any device)."""

from __future__ import annotations

import contextlib
import math
import threading

import torch

from ..core.settings import DOT_PRECISIONS, product_precision


#: The open product scopes of the process, and the settings the outermost one
#: found (guarded by the lock: only the outermost exit restores them).
_scope_lock = threading.Lock()
_scope = {"depth": 0, "saved": None}
#: The product precision of this thread's innermost scope (unset: "highest").
_local = threading.local()


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


def current_precision() -> str:
    """The product precision of the innermost open :func:`products` scope
    of this thread: "highest", "high" or "default" ("highest" outside any
    scope). :func:`mm`, :func:`mv` and :func:`mv_t` compute at it."""
    return getattr(_local, "precision", "highest")


@contextlib.contextmanager
def products(precision: str | None = None):
    """A scope of torch products at ``precision`` (any name of
    :data:`~..core.settings.PRECISION_NAMES`; None keeps the enclosing
    scope's, "highest" outside any): the JAX package's
    ``jax.default_matmul_precision`` around each solve (models/admm.py:185,
    669, 843) and its factor (models/kkt.py:182). The port's product
    helpers (:func:`mm`, :func:`mv`, :func:`mv_t`, :func:`sub_mm_`) read
    it: "highest" is FP32, "default" the product of the operands rounded to
    bf16 once, "high" the bf16x3 sum of their halves, both accumulated in
    FP32 (the TPU's arithmetic, and that of the chunk kernels' "high" and
    "default"); float64 products run in full whatever the scope says.

    Whatever the precision, torch's own float32 products run in full FP32
    inside: the float32 matmul precision "highest", which also turns
    cuBLAS's TF32 off (``torch.backends.cuda.matmul.allow_tf32`` reads the
    same setting). On exit, also when the block raises, the caller's
    settings come back exactly: the precision and, on a torch with
    per-backend precisions, the cuda and mkldnn matmul ones. The
    hand-written kernels compute as they are written either way.

    The precision is local to the thread, as JAX's scope is. Torch's
    settings are global to the process: scopes nest and may overlap across
    threads, the outermost entry saves the caller's settings and the last
    exit restores them, so concurrent solves all run without TF32. While
    any scope is open, code of other threads outside it also sees
    "highest", and a setting another thread changes meanwhile is
    overwritten at the last exit.
    """
    inner = current_precision() if precision is None else product_precision(precision)
    with _scope_lock:
        if _scope["depth"] == 0:
            _scope["saved"] = _read_product_settings()
            torch.set_float32_matmul_precision("highest")
        _scope["depth"] += 1
    outer = current_precision()
    _local.precision = inner
    try:
        yield
    finally:
        _local.precision = outer
        with _scope_lock:
            _scope["depth"] -= 1
            if _scope["depth"] == 0:
                saved, backends = _scope["saved"]
                torch.set_float32_matmul_precision(saved)
                for m, value in backends:
                    m.fp32_precision = value


def fp32_products():
    """A :func:`products` scope at "highest": full-FP32 products inside,
    whatever the caller set (the prox family, which pins "highest" as the
    JAX package's models/proxqp.py:258, 295 do, and the SPD-inverse entry
    points that no solver calls)."""
    return products("highest")


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched M @ v: (*B, r, c) x (*B, c) -> (*B, r), in the input's dtype
    (the kernels' plain versions; the solvers' products go through
    :func:`mv`)."""
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


def _bf16_mm(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a @ b of two bfloat16 tensors (batch axes broadcast), accumulated in
    FP32 and returned in ``dtype``. On the card: cuBLAS's bf16 GEMM with
    FP32 output (``torch.mm``/``torch.bmm`` with ``out_dtype``), a 2-D
    operand folded into one ``mm``. Elsewhere: the product of the same
    bf16 values in ``dtype`` (a product of two bf16 values is exact in
    FP32, so only the accumulation order differs)."""
    if a.device.type != "cuda":
        return torch.matmul(a.to(dtype), b.to(dtype))
    f32 = torch.float32
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=f32)
        return out.reshape(a.shape[:-1] + b.shape[-1:])
    if a.dim() == 2:
        return _bf16_mm(b.transpose(-1, -2), a.transpose(-1, -2),
                        dtype).transpose(-1, -2)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(batch + a.shape[-2:]).reshape((-1,) + a.shape[-2:])
    b3 = b.expand(batch + b.shape[-2:]).reshape((-1,) + b.shape[-2:])
    out = torch.bmm(a3, b3, out_dtype=f32)
    return out.reshape(batch + out.shape[-2:])


def mm(a: torch.Tensor, b: torch.Tensor, precision: str | None = None) -> torch.Tensor:
    """a @ b (``torch.matmul``'s shapes, at least 2-D each) at ``precision``
    (None: the scope's, :func:`current_precision`), resolved for a's dtype:
    "highest" ``torch.matmul``; "default" the product of bf16(a) and
    bf16(b); "high" (ah bh + ah bl) + al bh of their bf16 halves, the chunk
    kernels' order (:func:`matvec_at`)."""
    prec = resolve_precision(current_precision() if precision is None
                             else precision, a.dtype)
    if prec == "highest":
        return torch.matmul(a, b)
    if prec == "default":
        return _bf16_mm(a.to(torch.bfloat16), b.to(torch.bfloat16), a.dtype)
    ah, al = bf16_split(a)
    bh, bl = bf16_split(b)
    return (_bf16_mm(ah, bh, a.dtype) + _bf16_mm(ah, bl, a.dtype)
            + _bf16_mm(al, bh, a.dtype))


def mv(M: torch.Tensor, v: torch.Tensor, precision: str | None = None) -> torch.Tensor:
    """Batched M @ v at the scope's precision (:func:`mm`)."""
    return mm(M, v.unsqueeze(-1), precision).squeeze(-1)


def mv_t(M: torch.Tensor, v: torch.Tensor, precision: str | None = None) -> torch.Tensor:
    """Batched M' @ v at the scope's precision (:func:`mm`)."""
    return mm(v.unsqueeze(-2), M, precision).squeeze(-2)


def sub_mm_(W: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """W -= a @ b in place on (B, r, c) W at the scope's precision: one
    ``baddbmm_`` at "highest", else W minus the :func:`mm` product."""
    if resolve_precision(current_precision(), W.dtype) == "highest":
        return W.baddbmm_(a, b, alpha=-1.0)
    return W.sub_(mm(a, b))


def inf_norm(v: torch.Tensor) -> torch.Tensor:
    """Batched infinity norm over the last axis; 0 for empty vectors."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return v.abs().amax(-1)


def inf_norm_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused ||a - b||_inf (reference `_NormInfDif`, ProxQP.jl:300-309)."""
    return inf_norm(a - b)


def batch_identity(batch_shape: tuple[int, ...], n: int, dtype: torch.dtype,
                   device=None) -> torch.Tensor:
    """The n x n identity broadcast to ``batch_shape`` (a view) on
    ``device``: callers pass their tensor's; None is the card
    (:func:`~..core.problem.default_device`)."""
    from ..core.problem import default_device

    eye = torch.eye(n, dtype=dtype, device=default_device(device))
    return eye.expand(tuple(batch_shape) + (n, n))


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


# Below this size the matmul recursion stops paying; use Cholesky.
_SPD_BASE_N = 64


def _spd_inverse_cholesky(M: torch.Tensor) -> torch.Tensor:
    L = torch.linalg.cholesky(M)
    eye = batch_identity(M.shape[:-2], M.shape[-1], M.dtype, M.device)
    return sym(torch.cholesky_solve(eye, L))


def spd_inverse_blocked(M: torch.Tensor, split: bool = False) -> torch.Tensor:
    """Recursive blocked SPD inverse: with M = [[A, B'], [B, C]],

        S = C - B A^{-1} B'          (SPD Schur complement)
        M^{-1} = [[A^{-1} + W' S^{-1} W,  -W' S^{-1}],
                  [-S^{-1} W,              S^{-1}]],   W = B A^{-1}.

    Two half-size recursive inversions and four batched products a level
    down to n <= 64 or an odd n (Cholesky there); only the result is
    symmetrized. The products go through :func:`mm` at the enclosing
    :func:`products` scope's precision ("highest" outside any), as the JAX
    package's einsums follow ``default_matmul_precision``; torch's own
    float32 products run without TF32 inside. ``split`` is accepted and
    unused, as in the JAX package. :func:`spd_inverse` does not dispatch
    here: off the sweep's shapes it takes Cholesky.
    """
    with products():
        return sym(_spd_inverse_blocked_raw(M))


def _spd_inverse_blocked_raw(M: torch.Tensor) -> torch.Tensor:
    n = M.shape[-1]
    if n <= _SPD_BASE_N or n % 2:
        return _spd_inverse_cholesky(M)
    h = n // 2
    A = M[..., :h, :h]
    B = M[..., h:, :h]
    C = M[..., h:, h:]
    A_inv = _spd_inverse_blocked_raw(A)
    W = mm(B, A_inv)
    S = C - mm(W, B.transpose(-1, -2))
    S_inv = _spd_inverse_blocked_raw(S)
    SW = mm(S_inv, W)
    top_left = A_inv + mm(W.transpose(-1, -2), SW)
    top = torch.cat([top_left, -SW.transpose(-1, -2)], dim=-1)
    bot = torch.cat([-SW, S_inv], dim=-1)
    return torch.cat([top, bot], dim=-2)
