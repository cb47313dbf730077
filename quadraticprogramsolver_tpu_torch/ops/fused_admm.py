"""Fused sigma-free ADMM chunk: K iterations per active lane in one launch.

Counterpart of ``quadraticprogramsolver_tpu/ops/fused_admm.py``
(``fused_admm_chunk(..., sigma_free=True)``) in its "highest", lanes=1,
refine=0 variant; the M^{-1} form, refinement, lane interleave, slab windows
and reduced-precision dots are queued in ROADMAP.md. On a CUDA tensor the
wrapper launches csrc/admm_chunk.cu; on a CPU tensor it runs
:func:`fused_admm_chunk_plain`.
"""

from __future__ import annotations

import torch

from .. import _build
from .linalg import matvec


def fused_admm_chunk_plain(G, A, g, l, u, x, z, y, rho_row, active, *,
                           K: int, alpha: float):
    """Plain PyTorch chunk; same arguments and outputs as
    :func:`fused_admm_chunk`. Any float dtype and device."""
    act = active.bool()[:, None]
    rho_inv = 1.0 / rho_row
    x0, z0, y0 = x, z, y
    xp, zp = x, z
    for _ in range(K):
        xx = matvec(G, rho_row * z - y) - g
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
    if x.device.type == "cpu":
        return fused_admm_chunk_plain(G, A, g, l, u, x, z, y, rho_row, active,
                                      K=K, alpha=alpha)
    if x.device.type != "cuda":
        raise ValueError(f"no chunk kernel for device {x.device}")
    B, n = x.shape
    m = l.shape[-1]
    shapes = {"G": (B, n, m), "A": (B, m, n), "g": (B, n), "l": (B, m),
              "u": (B, m), "z": (B, m), "y": (B, m), "rho_row": (B, m),
              "active": (B,)}
    for name, t in zip(shapes, (G, A, g, l, u, z, y, rho_row, active)):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"fused_admm_chunk: {name} is {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
    if n % 128 or m % 128 or K < 1:
        raise ValueError(f"chunk kernel needs n, m multiples of 128 and K >= 1; "
                         f"got n={n}, m={m}, K={K}")
    act = active.to(torch.int32).contiguous()
    outs = [torch.empty_like(v) for v in (x, z, y, x, z, z, x)]
    _build.require_cuda_f32("fused_admm_chunk", G, A, g, l, u, x, z, y,
                            rho_row, *outs)
    if act.device != x.device:
        raise ValueError("active must be on the operands' device")
    code = _build.load().lib.qps_admm_chunk(
        G.data_ptr(), A.data_ptr(), g.data_ptr(), l.data_ptr(), u.data_ptr(),
        rho_row.data_ptr(), x.data_ptr(), z.data_ptr(), y.data_ptr(),
        act.data_ptr(), *(o.data_ptr() for o in outs), B, n, m, K,
        float(alpha), _build.stream_ptr(x))
    fused_admm_chunk.launches += 1
    _build.check(code, "qps_admm_chunk")
    return tuple(outs)


fused_admm_chunk.launches = 0
