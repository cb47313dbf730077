"""Fused prox-ALM chunks: K iterations per active lane in one launch.

Counterpart of ``quadraticprogramsolver_tpu/ops/fused_proxqp.py``
(``fused_proxqp_chunk``) in every variant the solver reaches:

- :func:`fused_proxqp_chunk`, the sigma-free form, with ``lanes`` lanes per
  CTA and its products G t, C x and A x at ``dot_precision`` "highest"
  (FP32), "high" (bf16x3) or "default" (one bf16 pass). The column cache
  enters as one operand G = [Ga | Gc] (B, n, me + mi), so the x-update is
  one product with the concatenated t = [rho b - y; rho(d - s) - z];
- :func:`fused_proxqp_chunk_minv`, the M^{-1} form with ``refine``
  refinement passes, with ``lanes``.

On a CUDA tensor each wrapper launches its kernel in csrc/prox_chunk.cu; on
a CPU tensor it runs its plain version, which rounds to bf16 only float32
operands and runs any lane grouping as lanes=1 (the kernels give the same
bits).
"""

from __future__ import annotations

import collections

import torch

from .. import _build
from .linalg import PRECISIONS, dot_operand, matvec, matvec_at, resolve_precision


def _check_lanes(B, lanes):
    if lanes < 1 or B % lanes:
        raise ValueError(f"batch {B} not divisible by lanes={lanes}")


def fused_proxqp_chunk_plain(G, A, C, g, b, d, x, s, y, z, rho, active, *,
                             K: int, lanes: int = 1,
                             dot_precision: str = "highest"):
    """Plain PyTorch chunk; same arguments and outputs as
    :func:`fused_proxqp_chunk`. Any float dtype, device and batch shape
    (A, C, b and d may be shared across the batch)."""
    if dot_precision not in PRECISIONS:
        raise ValueError(f"dot_precision must be one of {tuple(PRECISIONS)}; "
                         f"got {dot_precision!r}")
    if x.dim() == 2:
        _check_lanes(x.shape[0], lanes)
    prec = resolve_precision(dot_precision, x.dtype)
    r = rho[..., None]
    Gop = dot_operand(G, prec)
    return _plain_chunk(
        lambda x, s, y, z: matvec_at(
            Gop, torch.cat([r * b - y, r * (d - s) - z], dim=-1), prec) - g,
        A, C, b, d, x, s, y, z, rho, active, K=K, precision=prec)


def _plain_chunk(kkt_solve, A, C, b, d, x, s, y, z, rho, active, *, K,
                 precision="highest"):
    """K masked prox-ALM iterations around ``kkt_solve(x, s, y, z) -> x``,
    with C x and A x at ``precision``."""
    act = active.bool()[..., None]
    r = rho[..., None]
    rho_inv = 1.0 / r
    Aop, Cop = dot_operand(A, precision), dot_operand(C, precision)
    x0, s0, y0, z0 = x, s, y, z
    for _ in range(K):
        x = kkt_solve(x, s, y, z)
        Cx = matvec_at(Cop, x, precision)
        Ax = matvec_at(Aop, x, precision)
        s = torch.clamp_min(d - Cx - rho_inv * z, 0.0)
        y = y + r * (Ax - b)
        z = torch.clamp_min(z + r * (Cx - d + s), 0.0)
    return (torch.where(act, x, x0), torch.where(act, s, s0),
            torch.where(act, y, y0), torch.where(act, z, z0))


def fused_proxqp_chunk(G, A, C, g, b, d, x, s, y, z, rho, active, *, K: int,
                       lanes: int = 1, dot_precision: str = "highest"):
    """Run K sigma-free prox-ALM iterations for every active lane.

    G (B, n, me + mi) = M^{-1}[A' C'], A (B, me, n), C (B, mi, n),
    g (B, n) = M^{-1}q, b/y (B, me), d/s/z (B, mi), x (B, n), rho (B,),
    active (B,) bool; ``lanes`` lanes per CTA (B must divide);
    ``dot_precision`` of G t, C x and A x: "highest", "high" (bf16x3) or
    "default" (one bf16 pass). Returns (x, s, y, z); a frozen lane passes
    its inputs through unchanged.
    """
    if not _build.launches_kernel("fused_proxqp_chunk", x):
        return fused_proxqp_chunk_plain(G, A, C, g, b, d, x, s, y, z, rho,
                                        active, K=K, lanes=lanes,
                                        dot_precision=dot_precision)
    B, n = x.shape
    me, mi = b.shape[-1], d.shape[-1]
    if dot_precision not in PRECISIONS:
        raise ValueError(f"dot_precision must be one of {tuple(PRECISIONS)}; "
                         f"got {dot_precision!r}")
    _check_lanes(B, lanes)
    if K < 1:
        raise ValueError(f"fused_proxqp_chunk: K must be >= 1; got {K}")
    outs = [torch.empty_like(v) for v in (x, s, y, z)]
    act = _build.check_chunk(
        "fused_proxqp_chunk",
        {"G": (G, (B, n, me + mi)), "A": (A, (B, me, n)), "C": (C, (B, mi, n)),
         "g": (g, (B, n)), "b": (b, (B, me)), "d": (d, (B, mi)),
         "x": (x, (B, n)), "s": (s, (B, mi)), "y": (y, (B, me)),
         "z": (z, (B, mi)), "rho": (rho, (B,))},
        {"n": n, "me": me, "mi": mi}, outs, active)
    _build.launch(
        fused_proxqp_chunk, "qps_prox_chunk",
        G.data_ptr(), A.data_ptr(), C.data_ptr(), g.data_ptr(), b.data_ptr(),
        d.data_ptr(), rho.data_ptr(), x.data_ptr(), s.data_ptr(), y.data_ptr(),
        z.data_ptr(), act.data_ptr(), *(o.data_ptr() for o in outs), B, n, me,
        mi, K, lanes, PRECISIONS[dot_precision], _build.stream_ptr(x),
        variant=f"{dot_precision},lanes{lanes}")
    return tuple(outs)


fused_proxqp_chunk.launches = 0
fused_proxqp_chunk.variants = collections.Counter()


def fused_proxqp_chunk_minv_plain(Minv, A, C, P, q, b, d, x, s, y, z, rho,
                                  active, *, K: int, sigma: float, refine: int,
                                  lanes: int = 1):
    """Plain PyTorch M^{-1}-form chunk; same arguments and outputs as
    :func:`fused_proxqp_chunk_minv`. Any float dtype, device and batch shape
    (A, C, P, q, b and d may be shared across the batch)."""
    if x.dim() == 2:
        _check_lanes(x.shape[0], lanes)
    r = rho[..., None]
    At, Ct = A.transpose(-1, -2), C.transpose(-1, -2)

    def kkt_solve(x, s, y, z):
        rhs = (-q + sigma * x + matvec(At, r * b - y)
               + matvec(Ct, r * (d - s) - z))
        x = matvec(Minv, rhs)
        for _ in range(refine):
            Mx = (matvec(P, x) + sigma * x
                  + r * (matvec(At, matvec(A, x)) + matvec(Ct, matvec(C, x))))
            x = x + matvec(Minv, rhs - Mx)
        return x

    return _plain_chunk(kkt_solve, A, C, b, d, x, s, y, z, rho, active, K=K)


def fused_proxqp_chunk_minv(Minv, A, C, P, q, b, d, x, s, y, z, rho, active,
                            *, K: int, sigma: float, refine: int,
                            lanes: int = 1):
    """Run K M^{-1}-form prox-ALM iterations for every active lane.

    Minv (B, n, n) = (P + sigma*I + rho(A'A + C'C))^{-1} (contracted as
    Minv @ r), A (B, me, n), C (B, mi, n), P (B, n, n) (read only when
    refine > 0; may then be None), q/x (B, n), b/y (B, me), d/s/z (B, mi),
    rho (B,), active (B,) bool. Each KKT solve takes ``refine`` refinement
    passes against the true M; ``lanes`` lanes per CTA (B must divide).
    Returns (x, s, y, z); a frozen lane passes its inputs through unchanged.
    """
    if not _build.launches_kernel("fused_proxqp_chunk_minv", x):
        return fused_proxqp_chunk_minv_plain(Minv, A, C, P, q, b, d, x, s, y,
                                             z, rho, active, K=K, sigma=sigma,
                                             refine=refine, lanes=lanes)
    B, n = x.shape
    me, mi = b.shape[-1], d.shape[-1]
    if K < 1 or refine < 0:
        raise ValueError(f"fused_proxqp_chunk_minv: K must be >= 1 and refine "
                         f">= 0; got K={K}, refine={refine}")
    _check_lanes(B, lanes)
    operands = {"Minv": (Minv, (B, n, n)), "A": (A, (B, me, n)),
                "C": (C, (B, mi, n)), "q": (q, (B, n)), "b": (b, (B, me)),
                "d": (d, (B, mi)), "x": (x, (B, n)), "s": (s, (B, mi)),
                "y": (y, (B, me)), "z": (z, (B, mi)), "rho": (rho, (B,))}
    if refine > 0:
        operands["P"] = (P, (B, n, n))
    outs = [torch.empty_like(v) for v in (x, s, y, z)]
    act = _build.check_chunk("fused_proxqp_chunk_minv", operands,
                             {"n": n, "me": me, "mi": mi}, outs, active)
    _build.launch(
        fused_proxqp_chunk_minv, "qps_prox_chunk_minv",
        Minv.data_ptr(), A.data_ptr(), C.data_ptr(),
        P.data_ptr() if refine > 0 else None, q.data_ptr(), b.data_ptr(),
        d.data_ptr(), rho.data_ptr(), x.data_ptr(), s.data_ptr(), y.data_ptr(),
        z.data_ptr(), act.data_ptr(), *(o.data_ptr() for o in outs), B, n, me,
        mi, K, refine, lanes, float(sigma), _build.stream_ptr(x),
        variant=f"lanes{lanes}")
    return tuple(outs)


fused_proxqp_chunk_minv.launches = 0
fused_proxqp_chunk_minv.variants = collections.Counter()
