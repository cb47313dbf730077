"""Dense CHOLESKY KKT backend (counterpart of the JAX package's models/kkt.py).

Every iteration solves the reduced KKT system with M = P + sigma*I +
A' diag(rho) A (SPD):

    xx = M^{-1} (sigma*x - q + A'(rho*z - y)),      zz = A xx,

or, in sigma-free form (Settings.sigma_free_rhs), xx = G(rho*z - y) - g with
the cached G = M^{-1}A' and g = M^{-1}q: a copy {G, g}, the factor's slab
{S, g} (Settings.slab_cache) or G's bf16 halves {Ghi, Glo, g}
(Settings.split_cache). Off the fused slab factor, M^{-1}
and {G, g} come from ``spd_inverse``/``spd_solve`` (ops/linalg.py: the
blocked Gauss-Jordan sweep around the pivot kernel on its shapes, Cholesky
elsewhere). Only the CHOLESKY backend is ported; AUTO resolves to it or
raises.
"""

from __future__ import annotations

import torch

from ..core.problem import QP
from ..core.settings import MAX_DIRECT_KKT_DIM, KKTBackendKind, Settings
from ..ops.linalg import (add_scaled_identity, bf16_split, kernel_dtype_ok,
                          matvec, spd_inverse, spd_solve)


def resolve_backend(kind: KKTBackendKind, qp) -> KKTBackendKind:
    """AUTO -> CHOLESKY for dense problems under the direct-size threshold."""
    if kind is KKTBackendKind.CHOLESKY:
        return kind
    if kind is KKTBackendKind.AUTO and qp.n + qp.m <= MAX_DIRECT_KKT_DIM:
        return KKTBackendKind.CHOLESKY
    raise NotImplementedError(
        f"KKT backend {kind.value} (n + m = {qp.n + qp.m}) resolves to a "
        "backend the PyTorch port does not have yet (only CHOLESKY)")


def row_weights(qp, settings: Settings):
    """Per-constraint penalty weights w (rho_i = rho * w_i): equality rows
    get settings.rho_eq_scale; None when that is 1."""
    if settings.rho_eq_scale == 1.0:
        return None
    tol = 1e-9 * torch.clamp(qp.u.abs(), min=1.0)
    is_eq = qp.l.isfinite() & qp.u.isfinite() & ((qp.u - qp.l).abs() <= tol)
    one = torch.ones((), dtype=qp.dtype, device=qp.device)
    return torch.where(is_eq, one * settings.rho_eq_scale, one)


def rho_rows(qp, rho, settings: Settings):
    """(rho * w) as a (*B, m)-broadcastable tensor."""
    w = row_weights(qp, settings)
    r = rho[..., None]
    return r if w is None else r * w


def _full_rho_row(qp, rho, settings: Settings) -> torch.Tensor:
    return rho_rows(qp, rho, settings).expand(
        qp.batch_shape + (qp.m,)).contiguous()


def _build_normal_matrix(qp: QP, rho_row, sigma):
    """P + sigma*I + A' diag(rho_row) A."""
    AtWA = torch.matmul(qp.A.transpose(-1, -2) * rho_row[..., None, :], qp.A)
    return add_scaled_identity(qp.P + AtWA, sigma)


def _fused_factor_ok(qp: QP, settings: Settings) -> bool:
    return (
        settings.fused_factor
        and settings.sigma_free_rhs
        and kernel_dtype_ok(qp.dtype, qp.device)
        and len(qp.batch_shape) == 1
        and qp.n % 128 == 0 and qp.n > 0
        and qp.m % 128 == 0 and qp.m > 0
    )


def cholesky_init(qp: QP, rho, sigma, settings: Settings) -> dict:
    rho_row = _full_rho_row(qp, rho, settings)
    if _fused_factor_ok(qp, settings):
        from ..ops.fused_factor import fused_factor_solve

        # Settings.pivot_variant picks the pivot sweep; factor_precision
        # "high" the bf16x3 level products ("default" runs the FP32 level,
        # as in the JAX package). The build and the pivots stay FP32.
        S = fused_factor_solve(
            qp.P, qp.A, qp.q, rho_row, sigma=float(settings.sigma_for(qp.dtype)),
            pivot_variant=settings.pivot_variant,
            dot_precision=("high" if settings.factor_precision == "high"
                           else "highest"))
        g = S[..., qp.m].contiguous()
        if settings.split_cache and qp.dtype == torch.float32:
            # Settings.split_cache: G's two bf16 halves, split once here
            # exactly as the kernel splits in registers (ops/linalg.py:
            # bf16_split); the slab is freed when this returns. (Eager torch
            # keeps the bf16 round trip that the JAX package has to pin with
            # an optimization barrier.) In float64 the halves would round
            # the solve: there the cache stays G, as in JAX's f64 solve.
            Ghi, Glo = bf16_split(S[..., : qp.m])
            return {"Ghi": Ghi, "Glo": Glo, "g": g}
        if settings.slab_cache:
            # Settings.slab_cache: the chunk reads G as a window of the slab
            # (its first m columns), so no (B, n, m) copy is made; the slab
            # stays live through the solve.
            return {"S": S, "g": g}
        # Copies: the chunk kernel takes a contiguous (B, n, m) G, and the
        # slab (n x (kp + n) per lane) is freed when this returns.
        return {"G": S[..., : qp.m].contiguous(), "g": g}
    if settings.factor_precision in ("high", "default"):
        raise NotImplementedError(
            f"Settings.factor_precision={settings.factor_precision!r} off the "
            "fused slab factor (its gates fail for this problem: float32, or "
            "float64 on the CPU, one batch axis, n and m nonzero multiples "
            "of 128) is not implemented by the PyTorch port yet (see "
            "ROADMAP.md)")
    M = _build_normal_matrix(qp, rho_row, sigma)
    if settings.sigma_free_rhs:
        At = qp.A.transpose(-1, -2).expand(qp.batch_shape + (qp.n, qp.m))
        R = torch.cat([At, qp.q[..., :, None]], dim=-1)
        X = spd_solve(M, R)
        return {"G": X[..., : qp.m].contiguous(), "g": X[..., qp.m].contiguous()}
    return {"M_inv": spd_inverse(M)}


def _apply_normal(qp, rho_row, sigma, v):
    return qp.matvec_P(v) + sigma * v + qp.matvec_At(rho_row * qp.matvec_A(v))


def cholesky_solve(cache, qp: QP, x, z, y, rho, settings: Settings):
    sigma = settings.sigma_for(qp.dtype)
    rho_row = rho_rows(qp, rho, settings)
    if settings.sigma_free_rhs:
        # The slab and split caches exist only where the fused chunk runs
        # (Settings requires fused_chunk for them, and the fused factor's
        # gate implies the chunk's), so this path always holds a copy of G.
        xx = matvec(cache["G"], rho_row * z - y) - cache["g"]
        return xx, qp.matvec_A(xx)
    b = sigma * x - qp.q + qp.matvec_At(rho_row * z - y)
    M_inv = cache["M_inv"]
    xx = matvec(M_inv, b)
    for _ in range(settings.kkt_refinement_steps):
        xx = xx + matvec(M_inv, b - _apply_normal(qp, rho_row, sigma, xx))
    return xx, qp.matvec_A(xx)
