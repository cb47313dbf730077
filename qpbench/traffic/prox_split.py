"""Dense split-form fleets at the shape of proxsuite's random mixed QP
(Bambade et al., RSS 2022: n_eq = n_in = n/4, with the data dense),
batched on the device:

    P = M'M / n + I,   M ~ N(0, 1) (n x n)
    A (me x n), C (mi x n), q, x_f ~ N(0, 1)
    b = A x_f,   d = C x_f + 1      (x_f is strictly feasible)

``fleet`` is a frozen copy of
quadraticprogramsolver_tpu_torch/problems/prox_fleet.py: the same calls in
the same order, so the same generator state gives the same bits. ``orient``
turns a fleet by signs.
"""

from __future__ import annotations

import torch


def fleet(batch: int, n: int, me: int, mi: int, *, generator: torch.Generator,
          dtype: torch.dtype = torch.float32) -> dict:
    """{P, q, A, b, C, d} of a (batch, n, me, mi) fleet on
    ``generator.device``."""
    kw = dict(dtype=dtype, device=generator.device)
    M = torch.randn((batch, n, n), generator=generator, **kw)
    P = torch.matmul(M.transpose(1, 2), M)
    del M
    P /= n
    P += torch.eye(n, **kw)
    A = torch.randn((batch, me, n), generator=generator, **kw)
    C = torch.randn((batch, mi, n), generator=generator, **kw)
    xf = torch.randn((batch, n), generator=generator, **kw)
    q = torch.randn((batch, n), generator=generator, **kw)
    b = torch.matmul(A, xf.unsqueeze(-1)).squeeze(-1)
    d = torch.matmul(C, xf.unsqueeze(-1)).squeeze(-1) + 1.0
    return dict(P=P, q=q, A=A, b=b, C=C, d=d)


def orient(f: dict, *, generator: torch.Generator) -> dict:
    """Fleet ``f`` with each lane's variables and equality rows turned by
    signs drawn from ``generator``: x -> Dx, equality rows -> R rows, so
    P -> DPD, q -> Dq, A -> RAD, b -> Rb, C -> CD (an inequality row keeps
    its sense). Each lane is the same problem, its answer turned by the same
    signs, and takes the same iterations (see random_qp.orient). P, A and C
    are turned in place."""
    batch, n = f["q"].shape
    me = f["b"].shape[1]
    s = torch.randint(0, 2, (batch, n + me), generator=generator,
                      device=generator.device)
    s = (2 * s - 1).to(f["q"].dtype)
    dx, de = s[:, :n], s[:, n:]
    P = f["P"].mul_(dx.unsqueeze(2)).mul_(dx.unsqueeze(1))
    A = f["A"].mul_(de.unsqueeze(2)).mul_(dx.unsqueeze(1))
    C = f["C"].mul_(dx.unsqueeze(1))
    return dict(P=P, q=f["q"] * dx, A=A, b=f["b"] * de, C=C, d=f["d"])
