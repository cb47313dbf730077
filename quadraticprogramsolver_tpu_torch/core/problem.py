"""Dense batched QP containers on torch tensors: the box form

    min_x  0.5 x'Px + q'x   s.t.   l <= Ax <= u,   P PSD,

and the split form of the prox-ALM family (Ax = b, Cx <= d).

Every tensor carries optional leading batch axes ``(*B, ...)``; a fleet of
independent QPs is one problem whose tensors have a batch axis. A problem
lives on the device of its tensors; make_qp and make_proxqp put host (numpy)
input on the CUDA card unless the caller names another device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.linalg import mv, mv_t


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

    # The products run at the scope's precision (ops/linalg.py: products),
    # as the JAX package's einsums follow its matmul precision.
    def matvec_P(self, v: torch.Tensor) -> torch.Tensor:
        return mv(self.P, v)

    def matvec_A(self, v: torch.Tensor) -> torch.Tensor:
        return mv(self.A, v)

    def matvec_At(self, v: torch.Tensor) -> torch.Tensor:
        return mv_t(self.A, v)

    def diag_P(self) -> torch.Tensor:
        return torch.diagonal(self.P, dim1=-2, dim2=-1)

    def diag_AtA(self) -> torch.Tensor:
        return (self.A * self.A).sum(-2)

    def diag_AtWA(self, w: torch.Tensor) -> torch.Tensor:
        """diag(A' diag(w) A) for per-row penalty weights w (*B, m)."""
        return ((self.A * self.A) * w[..., :, None]).sum(-2)

    @property
    def is_dense(self) -> bool:
        return True

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


def default_device(device=None) -> torch.device:
    """The device for host (numpy) input: ``device`` when given, else the
    CUDA card. Raises when no card is present: the CPU is used only when the
    caller asks for it (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' to build on the CPU")
    return dev


def _as_tensors(arrays, dtype=None, device=None):
    """Array-likes (numpy, scipy sparse, tensors) as tensors. A tensor keeps
    its device unless ``device`` is given; host input goes to
    :func:`default_device`."""
    out = []
    for x in arrays:
        if hasattr(x, "toarray"):  # scipy sparse
            x = x.toarray()
        if isinstance(x, torch.Tensor):
            out.append(x.to(device=device or x.device, dtype=dtype or x.dtype))
            continue
        t = torch.tensor(np.asarray(x))  # a copy: the source may be read-only
        out.append(t.to(device=default_device(device), dtype=dtype or t.dtype))
    return out


def make_qp(P, q, A, l, u, dtype=None, device=None) -> QP:
    """Build a QP from array-likes (numpy, scipy sparse, tensors); host
    input goes to the CUDA card unless ``device`` says otherwise."""
    return QP(*_as_tensors((P, q, A, l, u), dtype, device))


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


def stack_qps(qps: list[QP], pad: bool = False) -> QP:
    """Stack QPs into one batched QP (leading axis = fleet).

    ``pad=True`` admits mixed problem sizes: every instance is padded
    (:func:`pad_qp`: inert variables and rows, provably non-binding) to the
    fleet's largest (n, m), so heterogeneous problems share one solve.
    Callers slice each lane's solution back with its own n
    (``sol.x[i, :n_i]``).
    """
    if pad:
        n_max = max(q.n for q in qps)
        m_max = max(q.m for q in qps)
        qps = [pad_qp(q, n_max, m_max) for q in qps]
    return QP(*(torch.stack(ts, dim=0) for ts in zip(*(q.tensors() for q in qps))))


@dataclasses.dataclass(frozen=True)
class ProxQPProblem:
    """Equality/inequality-split QP for the prox-ALM solver.

        min 0.5 x'Px + q'x   s.t.  Ax = b,  Cx <= d

    Shapes: P (*B, n, n), q (*B, n), A (*B, me, n), b (*B, me),
    C (*B, mi, n), d (*B, mi). The batch shape is q's.
    """

    P: torch.Tensor
    q: torch.Tensor
    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    d: torch.Tensor

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def n_eq(self) -> int:
        return self.A.shape[-2]

    @property
    def n_ineq(self) -> int:
        return self.C.shape[-2]

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self.q.shape[:-1])

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def is_dense(self) -> bool:
        return True

    def tensors(self):
        return (self.P, self.q, self.A, self.b, self.C, self.d)

    def to(self, *args, **kwargs) -> "ProxQPProblem":
        return ProxQPProblem(*(t.to(*args, **kwargs) for t in self.tensors()))

    # -- operator protocol (the JAX package's contract) --

    def matvec_P(self, v: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.P, v.unsqueeze(-1)).squeeze(-1)

    def matvec_A(self, v: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.A, v.unsqueeze(-1)).squeeze(-1)

    def matvec_At(self, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(w.unsqueeze(-2), self.A).squeeze(-2)

    def matvec_C(self, v: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.C, v.unsqueeze(-1)).squeeze(-1)

    def matvec_Ct(self, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(w.unsqueeze(-2), self.C).squeeze(-2)

    def diag_P(self) -> torch.Tensor:
        return torch.diagonal(self.P, dim1=-2, dim2=-1)

    def diag_AtA(self) -> torch.Tensor:
        return (self.A * self.A).sum(-2)

    def diag_CtC(self) -> torch.Tensor:
        return (self.C * self.C).sum(-2)

    def to_box_qp(self) -> QP:
        """Lower onto the box form l <= [A; C] x <= u: equalities become
        l = u = b, inequalities l = -inf, u = d."""
        A = torch.cat([self.A, self.C], dim=-2)
        l = torch.cat([self.b, torch.full_like(self.d, -float("inf"))], dim=-1)
        u = torch.cat([self.b, self.d], dim=-1)
        return QP(self.P, self.q, A, l, u)


def make_proxqp(P, q, A, b, C, d, dtype=None, device=None) -> ProxQPProblem:
    """Build a split-form problem from array-likes; host input goes to the
    CUDA card unless ``device`` says otherwise."""
    return ProxQPProblem(*_as_tensors((P, q, A, b, C, d), dtype, device))


def pad_proxqp(prob: ProxQPProblem, n_pad: int, me_pad: int,
               mi_pad: int) -> ProxQPProblem:
    """Zero-pad a split-form QP without changing its solution.

    Padded variables get P[i, i] = 1 and q[i] = 0 (optimum 0, uncoupled);
    padded equality rows are 0 = 0 (their dual stays at its 0 start) and
    padded inequality rows 0 <= 0, with s = z = 0 a fixed point of the
    prox-ALM updates.
    """
    n, me, mi = prob.n, prob.n_eq, prob.n_ineq
    if n_pad < n or me_pad < me or mi_pad < mi:
        raise ValueError(
            f"pad target ({n_pad},{me_pad},{mi_pad}) smaller than ({n},{me},{mi})")
    if (n_pad, me_pad, mi_pad) == (n, me, mi):
        return prob
    dn, de, di = n_pad - n, me_pad - me, mi_pad - mi
    F = torch.nn.functional
    P = F.pad(prob.P, (0, dn, 0, dn))
    if dn:
        idx = torch.arange(n, n_pad, device=P.device)
        P[..., idx, idx] = 1.0
    return ProxQPProblem(
        P=P, q=F.pad(prob.q, (0, dn)), A=F.pad(prob.A, (0, dn, 0, de)),
        b=F.pad(prob.b, (0, de)), C=F.pad(prob.C, (0, dn, 0, di)),
        d=F.pad(prob.d, (0, di)))
