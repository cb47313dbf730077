"""Canonical dense batched QP container on torch tensors.

    min_x  0.5 x'Px + q'x   s.t.   l <= Ax <= u,   P PSD.

Every tensor carries optional leading batch axes ``(*B, ...)``; a fleet of
independent QPs is one QP whose tensors have a batch axis. The device is the
device of the tensors: nothing here moves data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QP:
    """A (possibly batched) dense box-constrained QP.

    Shapes: P (*B, n, n), q (*B, n), A (*B, m, n), l (*B, m), u (*B, m).
    l/u may hold -inf/+inf.
    """

    P: torch.Tensor
    q: torch.Tensor
    A: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2]

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self.q.shape[:-1])

    @property
    def dtype(self) -> torch.dtype:
        return self.P.dtype

    @property
    def device(self) -> torch.device:
        return self.P.device

    def to(self, *args, **kwargs) -> "QP":
        return QP(*(t.to(*args, **kwargs) for t in self.tensors()))

    def tensors(self):
        return (self.P, self.q, self.A, self.l, self.u)

    def matvec_P(self, v: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.P, v.unsqueeze(-1)).squeeze(-1)

    def matvec_A(self, v: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.A, v.unsqueeze(-1)).squeeze(-1)

    def matvec_At(self, v: torch.Tensor) -> torch.Tensor:
        return torch.matmul(v.unsqueeze(-2), self.A).squeeze(-2)

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        """0.5 x'Px + q'x, batched over leading axes."""
        return 0.5 * (x * self.matvec_P(x)).sum(-1) + (self.q * x).sum(-1)


def validate_qp(qp: QP) -> None:
    """Shape, symmetry and bound-order validation (raises ValueError)."""
    n, m = qp.n, qp.m
    if tuple(qp.P.shape[-2:]) != (n, n):
        raise ValueError(f"P must be square (n, n); got {tuple(qp.P.shape)}")
    if qp.q.shape[-1] != n:
        raise ValueError(f"q must have {n} elements; got {tuple(qp.q.shape)}")
    if qp.A.shape[-1] != n:
        raise ValueError(f"A must have n={n} columns; got {tuple(qp.A.shape)}")
    if qp.l.shape[-1] != m or qp.u.shape[-1] != m:
        raise ValueError(f"l/u must have m={m} elements; got "
                         f"{tuple(qp.l.shape)}/{tuple(qp.u.shape)}")
    if tuple(qp.q.shape[:-1]) != tuple(qp.P.shape[:-2]):
        raise ValueError("batch shapes of P and q disagree")
    P = qp.P
    tol = 1e-6 * (1.0 + float(P.abs().max())) if P.numel() else 0.0
    if P.numel() and float((P - P.transpose(-1, -2)).abs().max()) > tol:
        raise ValueError("P must be symmetric")
    if bool((qp.l > qp.u).any()):
        raise ValueError("bounds must satisfy l <= u elementwise")


def make_qp(P, q, A, l, u, dtype=None, device=None) -> QP:
    """Build a QP from array-likes (numpy, scipy sparse, tensors)."""
    def conv(x):
        if hasattr(x, "toarray"):  # scipy sparse
            x = x.toarray()
        if isinstance(x, torch.Tensor):
            return x.to(device=device or x.device, dtype=dtype or x.dtype)
        t = torch.tensor(np.asarray(x))  # a copy: the source may be read-only
        return t.to(device=device or "cpu", dtype=dtype or t.dtype)

    return QP(*(conv(x) for x in (P, q, A, l, u)))


def pad_qp(qp: QP, n_pad: int, m_pad: int) -> QP:
    """Zero-pad a QP to (n_pad, m_pad) without changing its solution.

    Inert-padding contract: padded variables get P[i, i] = 1 and q[i] = 0
    (optimum 0, coupled to nothing); padded constraint rows are all-zero
    with bounds (-inf, +inf), so the projection never binds and their dual
    stays 0.
    """
    n, m = qp.n, qp.m
    if n_pad < n or m_pad < m:
        raise ValueError(f"pad target ({n_pad},{m_pad}) smaller than problem ({n},{m})")
    if n_pad == n and m_pad == m:
        return qp
    dn, dm = n_pad - n, m_pad - m
    F = torch.nn.functional
    P = F.pad(qp.P, (0, dn, 0, dn))
    if dn:
        idx = torch.arange(n, n_pad, device=P.device)
        P[..., idx, idx] = 1.0
    q = F.pad(qp.q, (0, dn))
    A = F.pad(qp.A, (0, dn, 0, dm))
    l = F.pad(qp.l, (0, dm), value=-float("inf"))
    u = F.pad(qp.u, (0, dm), value=float("inf"))
    return QP(P, q, A, l, u)
