"""Batched dense split-form (prox-ALM) fleets generated on the device.

Counterpart of ``benchmarks/proxqp_fleet.py:device_fleet`` (the shape of the
reference's ProxQP demo):

    P = M'M / n + I,   M ~ N(0, 1) (n x n)
    A (me x n), C (mi x n), q, x_f ~ N(0, 1)
    b = A x_f,   d = C x_f + 1      (x_f is strictly feasible)

The random numbers come from the explicit ``generator`` on its own device,
so the bits differ from JAX's: compare distributions, not values.
"""

from __future__ import annotations

import torch

from ..core.problem import ProxQPProblem


def device_prox_fleet(batch: int, n: int, me: int, mi: int, *,
                      generator: torch.Generator,
                      dtype: torch.dtype = torch.float32) -> ProxQPProblem:
    """A (batch, n, me, mi) split-form fleet on ``generator.device``."""
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
    return ProxQPProblem(P=P, q=q, A=A, b=b, C=C, d=d)
