"""Batched 128x128 SPD inverse: the v3 pivot sweep (csrc/pivot_sweep.cu).

Counterpart of ``quadraticprogramsolver_tpu/ops/spd_kernels.py``
(``pallas_spd_inverse_unrolled(variant="v3")``). Only the v3 variant is
ported; the others are queued in ROADMAP.md.
"""

from __future__ import annotations

import math

import torch

from .. import _build

NB = 128


def pivot_sweep_v3_plain(D: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch v3 sweep on (B, nb, nb): Jacobi scaling to unit
    diagonal, nb unpivoted Gauss-Jordan rank-1 steps with the folded row
    fix, unscaling. Any float dtype and device."""
    nb = D.shape[-1]
    s = torch.rsqrt(torch.diagonal(D, dim1=-2, dim2=-1))
    s_col, s_row = s[..., :, None], s[..., None, :]
    W = D * s_col * s_row  # new tensor; updated in place below
    eye = torch.eye(nb, dtype=D.dtype, device=D.device)
    for j in range(nb):
        r = W[..., j:j + 1, :].clone()            # (B, 1, nb) pivot row
        dinv = 1.0 / r[..., :, j:j + 1]           # (B, 1, 1)
        a = (W[..., :, j:j + 1] - eye[:, j:j + 1]) * dinv
        W -= a * (r - eye[j:j + 1, :])
    return (2.0 * eye - W) * s_col * s_row


def _spd_inverse_cholesky(D: torch.Tensor) -> torch.Tensor:
    L = torch.linalg.cholesky(D)
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device).expand_as(D)
    inv = torch.cholesky_solve(eye, L)
    return 0.5 * (inv + inv.transpose(-1, -2))


def _pivot_sweep_v3_cuda(D: torch.Tensor) -> torch.Tensor:
    B = D.shape[0]
    if D.shape[1:] != (NB, NB):
        raise ValueError(f"pivot kernel takes (B, {NB}, {NB}); got {tuple(D.shape)}")
    if D.dtype != torch.float32 or D.stride(-1) != 1:
        raise ValueError("pivot kernel takes float32 with unit column stride "
                         f"(got {D.dtype}, strides {D.stride()})")
    out = torch.empty((B, NB, NB), dtype=torch.float32, device=D.device)
    _build.require_cuda_f32("spd_inverse_unrolled", out)
    if D.device != out.device:
        raise ValueError("operands on different devices")
    lib = _build.load().lib
    code = lib.qps_pivot_sweep_v3(D.data_ptr(), D.stride(0), D.stride(1),
                                  out.data_ptr(), B, _build.stream_ptr(D))
    spd_inverse_unrolled.launches += 1
    _build.check(code, "qps_pivot_sweep_v3")
    return out


def spd_inverse_unrolled(D: torch.Tensor, *, variant: str = "v3") -> torch.Tensor:
    """Batched (..., 128, 128) SPD inverse by the v3 pivot sweep.

    On a CUDA tensor this launches the kernel (float32; D may be a strided
    view with unit column stride, e.g. a pivot block of the factor slab);
    on a CPU tensor it runs :func:`pivot_sweep_v3_plain`. Like the JAX
    package, a flat batch below 4 blocks is inverted by Cholesky instead
    (its size rule, on either device).
    """
    if variant != "v3":
        raise NotImplementedError(f"pivot variant {variant!r} is not ported")
    batch_shape, nb = D.shape[:-2], D.shape[-1]
    if D.shape[-2] != nb or nb % NB:
        raise ValueError(f"blocks must be (nb, nb) with nb % {NB} == 0; got "
                         f"{tuple(D.shape)}")
    B = math.prod(batch_shape)
    D3 = D.reshape((B, nb, nb))
    if B < 4:
        return _spd_inverse_cholesky(D3).reshape(D.shape)
    if D.device.type == "cpu":
        return pivot_sweep_v3_plain(D3).reshape(D.shape)
    if D.device.type != "cuda":
        raise ValueError(f"no pivot kernel for device {D.device}")
    return _pivot_sweep_v3_cuda(D3).reshape(D.shape)


spd_inverse_unrolled.launches = 0
