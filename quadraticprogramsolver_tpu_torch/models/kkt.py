"""Dense CHOLESKY KKT backend (counterpart of the JAX package's models/kkt.py).

Every iteration solves the reduced KKT system with M = P + sigma*I +
A' diag(rho) A (SPD):

    xx = M^{-1} (sigma*x - q + A'(rho*z - y)),      zz = A xx,

or, in sigma-free form (Settings.sigma_free_rhs), xx = G(rho*z - y) - g with
the cached G = M^{-1}A' and g = M^{-1}q. Only the CHOLESKY backend is ported;
AUTO resolves to it or raises.
"""

from __future__ import annotations

import torch

from ..core.problem import QP
from ..core.settings import MAX_DIRECT_KKT_DIM, KKTBackendKind, Settings
from ..ops.linalg import add_scaled_identity, matvec, spd_inverse, spd_solve


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


def kernel_dtype_ok(dtype, device) -> bool:
    """The CUDA kernels take float32; the plain versions that stand in for
    them on the CPU also take float64 (so f64 parity runs the same path)."""
    if dtype == torch.float32:
        return True
    return dtype == torch.float64 and torch.device(device).type == "cpu"


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

        S = fused_factor_solve(qp.P, qp.A, qp.q, rho_row,
                               sigma=float(settings.sigma_for(qp.dtype)))
        # Copies: the chunk kernel takes a contiguous (B, n, m) G, and the
        # slab (n x (kp + n) per lane) is freed when this returns.
        return {"G": S[..., : qp.m].contiguous(), "g": S[..., qp.m].contiguous()}
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
        xx = matvec(cache["G"], rho_row * z - y) - cache["g"]
        return xx, qp.matvec_A(xx)
    b = sigma * x - qp.q + qp.matvec_At(rho_row * z - y)
    M_inv = cache["M_inv"]
    xx = matvec(M_inv, b)
    for _ in range(settings.kkt_refinement_steps):
        xx = xx + matvec(M_inv, b - _apply_normal(qp, rho_row, sigma, xx))
    return xx, qp.matvec_A(xx)
