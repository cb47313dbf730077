"""Batched random_qp fleets generated on the device.

Counterpart of ``bench.py:device_random_qp_fleet`` (the reference generator's
random_qp family, GenerateQuadraticProgram.jl:10-36):

    P = M'M + 1e-2 I,   M sparse (density 0.15) with normal values
    A sparse (density 0.15) with normal values,  q ~ N(0, 1)
    l = -U(0, 1),  u = U(0, 1);  15% of rows get l = u, another 15% u = 1

The random numbers come from the explicit ``generator`` on its own device,
so the bits differ from JAX's: compare distributions, not values.
"""

from __future__ import annotations

import torch

from ..core.problem import QP

DENSITY = 0.15
P_SHIFT = 1e-2


def device_random_qp_fleet(batch: int, n: int, m: int, *,
                           generator: torch.Generator,
                           n_pad: int | None = None, m_pad: int | None = None,
                           dtype: torch.dtype = torch.float32) -> QP:
    """A (batch, n, m) random_qp fleet on ``generator.device``.

    ``n_pad``/``m_pad`` generate the fleet padded at birth, with the inert
    padding contract of :func:`~..core.problem.pad_qp`: rows and columns of
    M and A beyond (n, m) are zero, padded P diagonal entries are 1, padded
    q entries 0, and padded rows get bounds (-inf, +inf).
    """
    np_, mp_ = n_pad or n, m_pad or m
    if np_ < n or mp_ < m:
        raise ValueError(f"pad target ({np_}, {mp_}) smaller than ({n}, {m})")
    kw = dict(dtype=dtype, device=generator.device)

    def masked_normal(r, c, r_real, c_real):
        M = torch.randn((batch, r, c), generator=generator, **kw)
        M *= torch.rand((batch, r, c), generator=generator, **kw) < DENSITY
        if r_real < r:
            M[:, r_real:, :] = 0.0
        if c_real < c:
            M[:, :, c_real:] = 0.0
        return M

    Mm = masked_normal(np_, np_, n, n)
    d = torch.full((np_,), 1.0, **kw)
    d[:n] = P_SHIFT
    P = torch.matmul(Mm.transpose(1, 2), Mm)
    del Mm
    P += torch.diag(d)
    A = masked_normal(mp_, np_, m, n)

    q = torch.randn((batch, np_), generator=generator, **kw)
    l = -torch.rand((batch, mp_), generator=generator, **kw)
    u = torch.rand((batch, mp_), generator=generator, **kw)
    mask_eq = torch.rand((batch, mp_), generator=generator, **kw) <= 0.15
    mask_u1 = torch.rand((batch, mp_), generator=generator, **kw) <= 0.15
    l = torch.where(mask_eq, u, l)
    u = u.masked_fill(mask_u1, 1.0)
    q[:, n:] = 0.0
    l[:, m:] = -float("inf")
    u[:, m:] = float("inf")
    return QP(P=P, q=q, A=A, l=l, u=u)
