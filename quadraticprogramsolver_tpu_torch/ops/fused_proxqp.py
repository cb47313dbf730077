"""Fused sigma-free prox-ALM chunk: K iterations per active lane in one launch.

Counterpart of ``quadraticprogramsolver_tpu/ops/fused_proxqp.py``
(``fused_proxqp_chunk(..., sigma_free=True)``) in its "highest", lanes=1,
refine=0 variant; the M^{-1} form, refinement, lane interleave and
reduced-precision dots are queued in ROADMAP.md. The column cache enters as
one operand G = [Ga | Gc] (B, n, me + mi), so the x-update is one product
with the concatenated t = [rho b - y; rho(d - s) - z]. On a CUDA tensor the
wrapper launches csrc/prox_chunk.cu; on a CPU tensor it runs
:func:`fused_proxqp_chunk_plain`.
"""

from __future__ import annotations

import torch

from .. import _build
from .linalg import matvec


def fused_proxqp_chunk_plain(G, A, C, g, b, d, x, s, y, z, rho, active, *,
                             K: int):
    """Plain PyTorch chunk; same arguments and outputs as
    :func:`fused_proxqp_chunk`. Any float dtype, device and batch shape
    (A, C, b and d may be shared across the batch)."""
    act = active.bool()[..., None]
    r = rho[..., None]
    rho_inv = 1.0 / r
    x0, s0, y0, z0 = x, s, y, z
    for _ in range(K):
        t = torch.cat([r * b - y, r * (d - s) - z], dim=-1)
        x = matvec(G, t) - g
        Cx = matvec(C, x)
        Ax = matvec(A, x)
        s = torch.clamp_min(d - Cx - rho_inv * z, 0.0)
        y = y + r * (Ax - b)
        z = torch.clamp_min(z + r * (Cx - d + s), 0.0)
    return (torch.where(act, x, x0), torch.where(act, s, s0),
            torch.where(act, y, y0), torch.where(act, z, z0))


def fused_proxqp_chunk(G, A, C, g, b, d, x, s, y, z, rho, active, *, K: int):
    """Run K sigma-free prox-ALM iterations for every active lane.

    G (B, n, me + mi) = M^{-1}[A' C'], A (B, me, n), C (B, mi, n),
    g (B, n) = M^{-1}q, b/y (B, me), d/s/z (B, mi), x (B, n), rho (B,),
    active (B,) bool. Returns (x, s, y, z); a frozen lane passes its inputs
    through unchanged.
    """
    if x.device.type == "cpu":
        return fused_proxqp_chunk_plain(G, A, C, g, b, d, x, s, y, z, rho,
                                        active, K=K)
    if x.device.type != "cuda":
        raise ValueError(f"no chunk kernel for device {x.device}")
    B, n = x.shape
    me, mi = b.shape[-1], d.shape[-1]
    shapes = {"G": (B, n, me + mi), "A": (B, me, n), "C": (B, mi, n),
              "g": (B, n), "b": (B, me), "d": (B, mi), "s": (B, mi),
              "y": (B, me), "z": (B, mi), "rho": (B,), "active": (B,)}
    for name, t in zip(shapes, (G, A, C, g, b, d, s, y, z, rho, active)):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"fused_proxqp_chunk: {name} is {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
    if n % 128 or me % 128 or mi % 128 or me == 0 or mi == 0 or K < 1:
        raise ValueError(f"prox chunk kernel needs n, me, mi nonzero multiples "
                         f"of 128 and K >= 1; got n={n}, me={me}, mi={mi}, K={K}")
    act = active.to(torch.int32).contiguous()
    outs = [torch.empty_like(v) for v in (x, s, y, z)]
    _build.require_cuda_f32("fused_proxqp_chunk", G, A, C, g, b, d, x, s, y, z,
                            rho, *outs)
    if act.device != x.device:
        raise ValueError("active must be on the operands' device")
    code = _build.load().lib.qps_prox_chunk(
        G.data_ptr(), A.data_ptr(), C.data_ptr(), g.data_ptr(), b.data_ptr(),
        d.data_ptr(), rho.data_ptr(), x.data_ptr(), s.data_ptr(), y.data_ptr(),
        z.data_ptr(), act.data_ptr(), *(o.data_ptr() for o in outs), B, n, me,
        mi, K, _build.stream_ptr(x))
    fused_proxqp_chunk.launches += 1
    _build.check(code, "qps_prox_chunk")
    return tuple(outs)


fused_proxqp_chunk.launches = 0
