"""Fused ADMM chunks: K iterations per active lane in one launch.

Counterpart of ``quadraticprogramsolver_tpu/ops/fused_admm.py``
(``fused_admm_chunk``) in its "highest", lanes=1 variants: the sigma-free
form (:func:`fused_admm_chunk`) and the M^{-1} form with ``refine``
refinement passes (:func:`fused_admm_chunk_minv`). Lane interleave, slab
windows and reduced-precision dots are queued in ROADMAP.md. On a CUDA
tensor each wrapper launches its kernel in csrc/admm_chunk.cu; on a CPU
tensor it runs its plain version.
"""

from __future__ import annotations

import torch

from .. import _build
from .linalg import matvec


def fused_admm_chunk_plain(G, A, g, l, u, x, z, y, rho_row, active, *,
                           K: int, alpha: float):
    """Plain PyTorch chunk; same arguments and outputs as
    :func:`fused_admm_chunk`. Any float dtype and device."""
    return _plain_chunk(lambda x, z, y: matvec(G, rho_row * z - y) - g,
                        A, l, u, x, z, y, rho_row, active, K=K, alpha=alpha)


def _plain_chunk(kkt_solve, A, l, u, x, z, y, rho_row, active, *, K, alpha):
    """K masked ADMM iterations around ``kkt_solve(x, z, y) -> xx``."""
    act = active.bool()[:, None]
    rho_inv = 1.0 / rho_row
    x0, z0, y0 = x, z, y
    xp, zp = x, z
    for _ in range(K):
        xx = kkt_solve(x, z, y)
        zz = matvec(A, xx)
        xp, zp = x, z
        x = alpha * xx + (1.0 - alpha) * xp
        zr = alpha * zz + (1.0 - alpha) * zp
        z = torch.minimum(torch.maximum(zr + rho_inv * y, l), u)
        y = y + rho_row * (zr - z)
    x = torch.where(act, x, x0)
    z = torch.where(act, z, z0)
    y = torch.where(act, y, y0)
    xp = torch.where(act, xp, x0)
    zp = torch.where(act, zp, z0)
    Ax = matvec(A, x)
    ATy = torch.matmul(y.unsqueeze(-2), A).squeeze(-2)
    return x, z, y, xp, zp, Ax, ATy


def fused_admm_chunk(G, A, g, l, u, x, z, y, rho_row, active, *,
                     K: int, alpha: float):
    """Run K sigma-free ADMM iterations for every active lane.

    G (B, n, m) = M^{-1}A', A (B, m, n), g (B, n) = M^{-1}q, l/u/z/y/rho_row
    (B, m), x (B, n), active (B,) bool. Returns (x, z, y, x_prev, z_prev,
    Ax, ATy): prev is the iterate at the start of the last iteration; frozen
    lanes pass through with prev = current; Ax and A'y are the check
    products of the returned x and y, computed for frozen lanes too.
    """
    if not _build.launches_kernel("fused_admm_chunk", x):
        return fused_admm_chunk_plain(G, A, g, l, u, x, z, y, rho_row, active,
                                      K=K, alpha=alpha)
    B, n = x.shape
    m = l.shape[-1]
    if K < 1:
        raise ValueError(f"fused_admm_chunk: K must be >= 1; got {K}")
    outs = [torch.empty_like(v) for v in (x, z, y, x, z, z, x)]
    act = _build.check_chunk(
        "fused_admm_chunk",
        {"G": (G, (B, n, m)), "A": (A, (B, m, n)), "g": (g, (B, n)),
         "l": (l, (B, m)), "u": (u, (B, m)), "x": (x, (B, n)), "z": (z, (B, m)),
         "y": (y, (B, m)), "rho_row": (rho_row, (B, m))},
        {"n": n, "m": m}, outs, active)
    _build.launch(
        fused_admm_chunk, "qps_admm_chunk",
        G.data_ptr(), A.data_ptr(), g.data_ptr(), l.data_ptr(), u.data_ptr(),
        rho_row.data_ptr(), x.data_ptr(), z.data_ptr(), y.data_ptr(),
        act.data_ptr(), *(o.data_ptr() for o in outs), B, n, m, K,
        float(alpha), _build.stream_ptr(x))
    return tuple(outs)


fused_admm_chunk.launches = 0


def fused_admm_chunk_minv_plain(Minv, A, P, q, l, u, x, z, y, rho_row, active,
                                *, K: int, alpha: float, sigma: float,
                                refine: int):
    """Plain PyTorch M^{-1}-form chunk; same arguments and outputs as
    :func:`fused_admm_chunk_minv`. Any float dtype and device."""
    At = A.transpose(-1, -2)

    def kkt_solve(x, z, y):
        rhs = sigma * x - q + matvec(At, rho_row * z - y)
        xx = matvec(Minv, rhs)
        for _ in range(refine):
            Mxx = matvec(P, xx) + sigma * xx + matvec(At, rho_row * matvec(A, xx))
            xx = xx + matvec(Minv, rhs - Mxx)
        return xx

    return _plain_chunk(kkt_solve, A, l, u, x, z, y, rho_row, active, K=K,
                        alpha=alpha)


def fused_admm_chunk_minv(Minv, A, P, q, l, u, x, z, y, rho_row, active, *,
                          K: int, alpha: float, sigma: float, refine: int):
    """Run K M^{-1}-form ADMM iterations for every active lane.

    Minv (B, n, n) = (P + sigma*I + A' diag(rho_row) A)^{-1} (contracted as
    Minv @ rhs), A (B, m, n), P (B, n, n) (read only when refine > 0; may
    then be None), q/x (B, n), l/u/z/y/rho_row (B, m), active (B,) bool.
    Each KKT solve takes ``refine`` refinement passes against the true M
    built from P and A. Returns what :func:`fused_admm_chunk` returns.
    """
    if not _build.launches_kernel("fused_admm_chunk_minv", x):
        return fused_admm_chunk_minv_plain(Minv, A, P, q, l, u, x, z, y,
                                           rho_row, active, K=K, alpha=alpha,
                                           sigma=sigma, refine=refine)
    B, n = x.shape
    m = l.shape[-1]
    if K < 1 or refine < 0:
        raise ValueError(f"fused_admm_chunk_minv: K must be >= 1 and refine "
                         f">= 0; got K={K}, refine={refine}")
    operands = {"Minv": (Minv, (B, n, n)), "A": (A, (B, m, n)),
                "q": (q, (B, n)), "l": (l, (B, m)), "u": (u, (B, m)),
                "x": (x, (B, n)), "z": (z, (B, m)), "y": (y, (B, m)),
                "rho_row": (rho_row, (B, m))}
    if refine > 0:
        operands["P"] = (P, (B, n, n))
    outs = [torch.empty_like(v) for v in (x, z, y, x, z, z, x)]
    act = _build.check_chunk("fused_admm_chunk_minv", operands,
                             {"n": n, "m": m}, outs, active)
    _build.launch(
        fused_admm_chunk_minv, "qps_admm_chunk_minv",
        Minv.data_ptr(), A.data_ptr(), P.data_ptr() if refine > 0 else None,
        q.data_ptr(), l.data_ptr(), u.data_ptr(), rho_row.data_ptr(),
        x.data_ptr(), z.data_ptr(), y.data_ptr(), act.data_ptr(),
        *(o.data_ptr() for o in outs), B, n, m, K, refine, float(alpha),
        float(sigma), _build.stream_ptr(x))
    return tuple(outs)


fused_admm_chunk_minv.launches = 0
