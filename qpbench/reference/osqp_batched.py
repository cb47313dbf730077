"""osqp_f64's iteration over a whole fleet in plain torch: the control.

The same OSQP-ADMM as ``osqp_f64.solve_qp_reference`` (x = z = y = 0, alpha,
sigma, the square-root adaptive-rho rule with its 5x refactor hysteresis, a
check every ``check_interval`` iterations, the primal/dual and fixed-point
stopping tests), one lane a row, each lane frozen once it stops. The linear
system is the reduced one, (P + sigma I + rho A'A) x~ = sigma x - q +
A'(rho z - y), z~ = A x~, through an explicit inverse a lane.

``precision="float64"`` computes in float64 (the tests hold it to
osqp_f64). ``precision="tf32"`` is the control: float32 storage and FP32
accumulation with every product's operands rounded to TF32 (10-bit
mantissa, round to nearest even), the precision next below the float32 with
TF32 off that the configurations state. Rounding the operands here rather
than switching TF32 on in cuBLAS makes every product TF32 on any device,
matrix-vector products included. It imports torch only.
"""

from __future__ import annotations

import torch

RHO_MIN, RHO_MAX = 1e-3, 1e6


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32's 10-bit mantissa (nearest even)."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _inf(v: torch.Tensor) -> torch.Tensor:
    return v.abs().amax(-1) if v.shape[-1] else v.new_zeros(v.shape[:-1])


def solve_fleet(P, q, A, l, u, *, precision: str = "tf32",
                max_iterations: int = 2000, eps_abs: float = 1e-4,
                eps_rel: float = 1e-4, rho: float = 0.1,
                sigma: float = 1e-6, alpha: float = 1.6,
                rho_factor: float = 5.0, check_interval: int = 25) -> dict:
    """Solve the (B, n, m) fleet; returns {x, z, y, status, iterations}
    (status 1 max iterations, 2 ADMM fixed point, 3 primal and dual)."""
    if precision == "float64":
        dtype, rnd = torch.float64, (lambda t: t)
    elif precision == "tf32":
        dtype, rnd = torch.float32, round_tf32
    else:
        raise ValueError(f"precision must be 'float64' or 'tf32'; got {precision!r}")
    P, q, A, l, u = (t.to(dtype) for t in (P, q, A, l, u))
    B, n, m = A.shape[0], A.shape[-1], A.shape[-2]
    Pr, Ar = rnd(P), rnd(A)
    Atr = Ar.transpose(1, 2).contiguous()
    eye = torch.eye(n, dtype=dtype, device=P.device)
    AtA = torch.bmm(Atr, Ar)

    def mv(M, v):
        return torch.bmm(M, rnd(v).unsqueeze(-1)).squeeze(-1)

    def inverse(rho_l):
        K = P + sigma * eye + rho_l[:, None, None] * AtA
        return rnd(torch.cholesky_inverse(torch.linalg.cholesky(K)))

    x = torch.zeros(B, n, dtype=dtype, device=P.device)
    z = torch.zeros(B, m, dtype=dtype, device=P.device)
    y = torch.zeros_like(z)
    rho_l = torch.full((B,), rho, dtype=dtype, device=P.device)
    rho_cand = rho_l.clone()
    Kinv = inverse(rho_l)
    status = torch.zeros(B, dtype=torch.int32, device=P.device)
    iterations = torch.full((B,), max_iterations, dtype=torch.int32,
                            device=P.device)
    eps_admm = min(eps_abs, eps_rel) * 1e-2
    norm_q = _inf(q)
    for it in range(1, max_iterations + 1):
        active = status == 0
        trip = active & ((rho_cand * rho_factor < rho_l)
                         | (rho_cand > rho_factor * rho_l))
        if it > 1 and (it - 1) % check_interval == 0:
            if not bool(active.any()):
                break
            if bool(trip.any()):
                rho_l = torch.where(trip, rho_cand, rho_l)
                Kinv = inverse(rho_l)
        rhs = sigma * x - q + mv(Atr, rho_l[:, None] * z - y)
        xx = mv(Kinv, rhs)
        zz = mv(Ar, xx)
        x_new = alpha * xx + (1 - alpha) * x
        zr = alpha * zz + (1 - alpha) * z
        z_new = torch.clamp(zr + y / rho_l[:, None], l, u)
        y_new = y + rho_l[:, None] * (zr - z_new)
        a = active[:, None]
        x_prev, z_prev = x, z
        x = torch.where(a, x_new, x)
        z = torch.where(a, z_new, z)
        y = torch.where(a, y_new, y)
        if it % check_interval:
            continue
        Ax, Px, Aty = mv(Ar, x), mv(Pr, x), mv(Atr, y)
        res_prim, res_dual = _inf(Ax - z), _inf(Px + q + Aty)
        max_prim = torch.maximum(_inf(Ax), _inf(z))
        max_dual = torch.maximum(torch.maximum(_inf(Px), _inf(Aty)), norm_q)
        ok = (res_dual * max_prim) > 0
        ratio = (res_prim * max_dual) / torch.where(ok, res_dual * max_prim,
                                                    torch.ones_like(max_prim))
        cand = torch.clamp(rho_l * torch.sqrt(ratio), RHO_MIN, RHO_MAX)
        rho_cand = torch.where(active & ok, cand, rho_cand)
        solved = ((res_prim < eps_abs + eps_rel * max_prim)
                  & (res_dual < eps_abs + eps_rel * max_dual))
        fixed = ((_inf(x - x_prev) <= eps_admm) & (_inf(z - z_prev) <= eps_admm))
        new = torch.where(solved, 3, torch.where(fixed, 2, 0)).to(torch.int32)
        done = active & (new > 0)
        status = torch.where(done, new, status)
        iterations = torch.where(done, torch.full_like(iterations, it),
                                 iterations)
    status = status.masked_fill(status == 0, 1)
    return dict(x=x, z=z, y=y, status=status, iterations=iterations)
