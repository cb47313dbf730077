"""Modified Ruiz equilibration (OSQP §5.1) of a dense fleet on its device
and of a sparse problem on the host.

Counterpart of the JAX package's ``models/scaling.py: ScalingData,
equilibrate, equilibrate_sparse_host, scale_iterates, unscale_iterates``.
:func:`equilibrate` is the dense in-solve scaling of
``Settings.scaling_iters`` (torch elementwise math and reductions on the
fleet's device); the sparse host math is a numpy/scipy copy of JAX's, whose
scaling vectors come back as tensors on the problem's device. With
diagonal D (variables), E (constraints) and the cost scale c,

    P' = c D P D,  q' = c D q,  A' = E A D,  l' = E l,  u' = E u,

and a solution maps back as x = D x', z = E^{-1} z', y = E y' / c.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..core.problem import QP, default_device


@dataclasses.dataclass(frozen=True)
class ScalingData:
    d: torch.Tensor   # (*B, n) variable scaling
    e: torch.Tensor   # (*B, m) constraint scaling
    c: torch.Tensor   # (*B,) cost scaling

    def to(self, dtype, device) -> "ScalingData":
        return ScalingData(*(t.to(device=device, dtype=dtype)
                             for t in (self.d, self.e, self.c)))


def _safe_rsqrt_norm(norms: torch.Tensor) -> torch.Tensor:
    """1/sqrt(norm), with 1 for structurally zero rows and columns (so the
    inert padding of pad_qp stays inert)."""
    one = torch.ones((), dtype=norms.dtype, device=norms.device)
    return torch.where(norms > 0, torch.rsqrt(torch.clamp(norms, min=1e-30)),
                       one)


def equilibrate(qp: QP, num_iters: int = 10):
    """Returns (scaled_qp, ScalingData) for a dense (batched) QP. Bounds may
    hold +-inf (E is positive and finite, so they stay infinite). P and A
    without the batch axes (one matrix shared by the fleet) broadcast; the
    scaled ones carry the batch axes once the per-lane cost scale applies."""
    dt, dev = qp.dtype, qp.device
    batch = qp.batch_shape
    n, m = qp.n, qp.m
    P, A, q = qp.P, qp.A, qp.q
    d = torch.ones(batch + (n,), dtype=dt, device=dev)
    e = torch.ones(batch + (m,), dtype=dt, device=dev)
    c = torch.ones(batch, dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    for _ in range(num_iters):
        col_P = P.abs().amax(-2)
        col_A = (A.abs().amax(-2) if m
                 else torch.zeros(batch + (n,), dtype=dt, device=dev))
        dx = _safe_rsqrt_norm(torch.maximum(col_P, col_A))
        dz = (_safe_rsqrt_norm(A.abs().amax(-1)) if m
              else torch.zeros(batch + (0,), dtype=dt, device=dev))
        P = dx[..., :, None] * P * dx[..., None, :]
        if m:
            A = dz[..., :, None] * A * dx[..., None, :]
        q = dx * q
        d = d * dx
        e = e * dz
        # Cost normalization (OSQP: mean column norm of P vs ||q||_inf).
        mean_col = P.abs().amax(-2).mean(-1)
        q_norm = (q.abs().amax(-1) if n
                  else torch.zeros(batch, dtype=dt, device=dev))
        g_den = torch.maximum(mean_col, q_norm)
        g = torch.where(g_den > 0, 1.0 / torch.clamp(g_den, min=1e-30), one)
        P = g[..., None, None] * P
        q = g[..., None] * q
        c = c * g
    scaled = QP(P=P, q=q, A=A, l=e * qp.l, u=e * qp.u)
    return scaled, ScalingData(d=d, e=e, c=c)


def equilibrate_sparse_host(P, q, A, l, u, num_iters: int = 10, device=None):
    """Host-side modified Ruiz for scipy sparse problems (the large
    matrix-free path), run once on CSR at construction time: the container
    (``make_sparse_qp``) then stores the *scaled* problem and the solve maps
    residuals back through ``solve(..., scaling=)``.

    Returns (P_s, q_s, A_s, l_s, u_s, ScalingData) with scipy/numpy values
    for the first five; the ScalingData's float64 tensors go to the CUDA
    card unless ``device`` says otherwise (the solve casts them to the
    problem's dtype).
    """
    P = sp.csr_matrix(P, dtype=np.float64)
    A = sp.csr_matrix(A, dtype=np.float64)
    q = np.asarray(q, np.float64).copy()
    n = q.shape[0]
    m = A.shape[0]
    d = np.ones(n)
    e = np.ones(m)
    c = 1.0

    def col_abs_max(M):
        if M.nnz == 0:
            return np.zeros(M.shape[1])
        return np.abs(M).max(axis=0).toarray().ravel()

    def row_abs_max(M):
        if M.nnz == 0:
            return np.zeros(M.shape[0])
        return np.abs(M).max(axis=1).toarray().ravel()

    for _ in range(num_iters):
        col_P = col_abs_max(P)
        col_A = col_abs_max(A) if m else np.zeros(n)
        norms = np.maximum(col_P, col_A)
        dx = np.where(norms > 0, 1.0 / np.sqrt(np.maximum(norms, 1e-30)), 1.0)
        row_A = row_abs_max(A) if m else np.zeros(0)
        dz = np.where(row_A > 0, 1.0 / np.sqrt(np.maximum(row_A, 1e-30)), 1.0)
        Dx = sp.diags(dx)
        P = Dx @ P @ Dx
        if m:
            A = sp.diags(dz) @ A @ Dx
        q *= dx
        d *= dx
        e *= dz
        mean_col = col_abs_max(P).mean() if n else 0.0
        q_norm = np.abs(q).max() if n else 0.0
        g_den = max(mean_col, q_norm)
        g = 1.0 / max(g_den, 1e-30) if g_den > 0 else 1.0
        P = g * P
        q *= g
        c *= g

    l_s = e * np.asarray(l, np.float64)
    u_s = e * np.asarray(u, np.float64)
    dev = default_device(device)
    scal = ScalingData(*(torch.tensor(np.asarray(v, np.float64), device=dev)
                         for v in (d, e, c)))
    return P.tocsr(), q, A.tocsr(), l_s, u_s, scal


def scale_iterates(scaling: ScalingData, x=None, z=None, y=None):
    """Map unscaled warm starts into the scaled space."""
    xs = None if x is None else x / scaling.d
    zs = None if z is None else scaling.e * z
    ys = None if y is None else scaling.c[..., None] * y / scaling.e
    return xs, zs, ys


def unscale_iterates(scaling: ScalingData, x, z, y):
    """Map the scaled-space solution back: x = D x', z = E^-1 z',
    y = E y' / c."""
    return (
        scaling.d * x,
        z / scaling.e,
        scaling.e * y / scaling.c[..., None],
    )
