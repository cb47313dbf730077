"""The randomQp class of RoyiAvital/QuadraticProgramSolver's
GenerateQuadraticProgram.jl:10-36 (drawn after the OSQP paper's Random QP,
Stellato et al. 2020), batched on the device:

    P = M'M + 1e-2 I,   M sparse (density 0.15) with normal values
    A sparse (density 0.15) with normal values,  q ~ N(0, 1)
    l = -U(0, 1),  u = U(0, 1);  15% of rows get l = u, another 15% u = 1

``fleet`` is a frozen copy of
quadraticprogramsolver_tpu_torch/problems/device_fleet.py (without its
pad-at-birth option): the same calls in the same order, so the same
generator state gives the same bits. ``orient`` turns a fleet by signs.
"""

from __future__ import annotations

import torch

DENSITY = 0.15
P_SHIFT = 1e-2
EQ_ROW_SHARE = 0.15
U_ONE_ROW_SHARE = 0.15


def fleet(batch: int, n: int, m: int, *, generator: torch.Generator,
          dtype: torch.dtype = torch.float32) -> dict:
    """{P, q, A, l, u} of a (batch, n, m) fleet on ``generator.device``."""
    kw = dict(dtype=dtype, device=generator.device)

    def masked_normal(r, c):
        M = torch.randn((batch, r, c), generator=generator, **kw)
        M *= torch.rand((batch, r, c), generator=generator, **kw) < DENSITY
        return M

    Mm = masked_normal(n, n)
    P = torch.matmul(Mm.transpose(1, 2), Mm)
    del Mm
    P += torch.diag(torch.full((n,), P_SHIFT, **kw))
    A = masked_normal(m, n)
    q = torch.randn((batch, n), generator=generator, **kw)
    l = -torch.rand((batch, m), generator=generator, **kw)
    u = torch.rand((batch, m), generator=generator, **kw)
    mask_eq = torch.rand((batch, m), generator=generator, **kw) <= EQ_ROW_SHARE
    mask_u1 = torch.rand((batch, m), generator=generator, **kw) <= U_ONE_ROW_SHARE
    l = torch.where(mask_eq, u, l)
    u = u.masked_fill(mask_u1, 1.0)
    return dict(P=P, q=q, A=A, l=l, u=u)


def signs(shape, *, generator: torch.Generator, dtype: torch.dtype) -> torch.Tensor:
    """A tensor of +1 and -1 drawn from ``generator``, on its device."""
    s = torch.randint(0, 2, shape, generator=generator, device=generator.device)
    return (2 * s - 1).to(dtype)


def orient(f: dict, *, generator: torch.Generator) -> dict:
    """Fleet ``f`` with each lane's variables and constraint rows turned by
    signs drawn from ``generator``: x -> Dx, rows -> R rows, so P -> DPD,
    q -> Dq, A -> RAD and [l, u] -> R [l, u]. Each lane is the same problem,
    its answer turned by the same signs. The solver's iterates turn with it,
    bit for bit, since a product or a sum changes only its sign, and every
    stopping test reads magnitudes: each lane takes the same iterations.
    P and A are turned in place."""
    batch, n = f["q"].shape
    m = f["l"].shape[1]
    dx = signs((batch, n), generator=generator, dtype=f["q"].dtype)
    dr = signs((batch, m), generator=generator, dtype=f["q"].dtype)
    P = f["P"].mul_(dx.unsqueeze(2)).mul_(dx.unsqueeze(1))
    A = f["A"].mul_(dr.unsqueeze(2)).mul_(dx.unsqueeze(1))
    up = dr > 0
    l = torch.where(up, f["l"], -f["u"])
    u = torch.where(up, f["u"], -f["l"])
    return dict(P=P, q=f["q"] * dx, A=A, l=l, u=u)
