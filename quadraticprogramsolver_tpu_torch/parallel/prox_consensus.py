"""Block-split distributed prox-ALM: one large split-form QP with its
constraint rows split over the mesh's "blocks" axis (counterpart of the JAX
package's parallel/prox_consensus.py).

x stays replicated over the blocks; the equality rows (A, b, y) and the
inequality rows (C, d, s, z) are split; every rank computes the same
x-update because every x-space quantity is psum-reduced:

  * M = P + rho * psum_blocks(A_d'A_d + C_d'C_d) + sigma*I
  * r = -q + sigma*x + psum_blocks(A_d'(rho b_d - y_d)
                                   + C_d'(rho(d_d - s_d) - z_d))
  * dual residual ||Px + q + psum(A'y) + psum(C'z)||_inf
  * primal residual and norms: per-rank inf-norms reduced with pmax

s, y and z update row-locally. The PIQP criteria, the split-form
certificates and the tau-triggered double-square-root adaptive rho follow
models/proxqp.py, the refactor a psum'd gram rebuild; the host loop's flags
agree over the block group (core/lockstep.py).

Not supported here, as in JAX: the equality-KKT warm start (the start is
zeros, ``kkt_warm_start=False``), Anderson acceleration and the sigma-free
caches (single-device layouts).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.lockstep import lockstep, read_flags
from ..core.problem import ProxQPProblem
from ..core.settings import ProxQPSettings
from ..core.state import Status
from ..models.proxqp import ProxQPInfo, ProxQPSolution
from ..ops.linalg import (add_scaled_identity, fp32_products, inf_norm, mm,
                          mv, mv_t, spd_inverse)
from .consensus import BLOCK_AXIS
from .mesh import all_gather_cat, axis, rank_device, reducer


def _pad_rows(prob: ProxQPProblem, n_shards: int) -> ProxQPProblem:
    """Pad equality and inequality rows to multiples of the block axis.

    Padded equality rows are 0 = 0 (y stays at its 0 start); padded
    inequality rows are 0 <= 0 (s = z = 0 are fixed points of the updates).
    Neither adds to a residual or a reduction.
    """
    me_pad = -(-prob.n_eq // n_shards) * n_shards
    mi_pad = -(-prob.n_ineq // n_shards) * n_shards
    if (me_pad, mi_pad) == (prob.n_eq, prob.n_ineq):
        return prob
    de, di = me_pad - prob.n_eq, mi_pad - prob.n_ineq
    return dataclasses.replace(
        prob, A=F.pad(prob.A, (0, 0, 0, de)), b=F.pad(prob.b, (0, de)),
        C=F.pad(prob.C, (0, 0, 0, di)), d=F.pad(prob.d, (0, di)))


@fp32_products()
def solve_prox_block_split(prob: ProxQPProblem,
                           settings: ProxQPSettings = ProxQPSettings(),
                           mesh=None) -> ProxQPSolution:
    """Solve one large dense split-form QP with its constraint rows split
    over a 1-D mesh (default: every rank of the world, on the cards).
    Matches the single-card solve run with ``kkt_warm_start=False``. Every
    rank passes the whole problem and gets the whole solution back."""
    if prob.batch_shape:
        raise ValueError("solve_prox_block_split takes a single (unbatched) "
                         "ProxQPProblem; fleets shard with solve_prox_fleet")
    if settings.anderson_memory > 0:
        raise ValueError("Anderson acceleration is not supported in the "
                         "block-split prox solver (single-device layouts)")
    if settings.sigma_free_rhs:
        raise ValueError("sigma_free_rhs caches are single-device layouts; "
                         "the block-split solver builds M^{-1} via psum'd "
                         "gram blocks instead")
    if mesh is None:
        from .mesh import make_mesh

        mesh = make_mesh((dist.get_world_size(),), (BLOCK_AXIS,))
    rb, n_shards, group = axis(mesh, mesh.mesh_dim_names[0])
    me_orig, mi_orig = prob.n_eq, prob.n_ineq
    prob = _pad_rows(prob, n_shards)
    dev = rank_device(mesh)
    me_loc, mi_loc = prob.n_eq // n_shards, prob.n_ineq // n_shards

    def rows(t, k):
        return t[rb * k:(rb + 1) * k].to(dev).contiguous()

    Pm, q = prob.P.to(dev).contiguous(), prob.q.to(dev).contiguous()
    A, b = rows(prob.A, me_loc), rows(prob.b, me_loc)
    C, d = rows(prob.C, mi_loc), rows(prob.d, mi_loc)
    dt = Pm.dtype
    kw = dict(dtype=dt, device=dev)
    sigma = settings.sigma

    # Maxima reduced together are exact; a check's go in one collective.
    psum = reducer(group, dist.ReduceOp.SUM)
    pmax = reducer(group, dist.ReduceOp.MAX)

    def factor(rho):
        K = psum(mm(A.T, A) + mm(C.T, C))
        return spd_inverse(add_scaled_identity(Pm + rho * K, sigma))

    x = torch.zeros((Pm.shape[-1],), **kw)
    y = torch.zeros((me_loc,), **kw)
    s = torch.clamp_min(d, 0.0)
    z = torch.zeros((mi_loc,), **kw)
    rho = torch.tensor(settings.rho, **kw)
    M_inv = factor(rho)
    status = torch.zeros((), dtype=torch.int32, device=dev)
    iters = torch.tensor(settings.num_checks * settings.check_interval,
                         dtype=torch.int32, device=dev)
    rp_out = torch.tensor(float("inf"), **kw)
    rd_out = torch.tensor(float("inf"), **kw)
    hist = None
    if settings.record_history:
        hist = {k: torch.full((settings.num_checks,), float("inf"), **kw)
                for k in ("res_prim", "res_dual", "rho")}
    prev = None
    if settings.check_infeasibility:
        # Start-point products for the certificate deltas.
        prev = {"Px": mv(Pm, x), "Aty": psum(mv_t(A, y)),
                "Ctz": psum(mv_t(C, z)), "Ax": mv(A, x), "Cx": mv(C, x)}
    max_total = settings.num_checks * settings.check_interval
    it = 0
    trip = None
    with lockstep(group):
        while it < max_total:
            flags = [status == Status.RUNNING]
            if trip is not None:
                flags.append(trip)
            flags = read_flags(torch.stack(flags))
            if not flags[0]:
                break
            if trip is not None and flags[1]:
                M_inv = factor(rho)
            running = status == Status.RUNNING

            x_in, s_in, y_in, z_in = x, s, y, z
            for _ in range(settings.check_interval):
                r = (-q + sigma * x
                     + psum(mv_t(A, rho * b - y) + mv_t(C, rho * (d - s) - z)))
                x = mv(M_inv, r)
                for _ in range(settings.kkt_refinement_steps):
                    Mx = (mv(Pm, x) + sigma * x
                          + rho * psum(mv_t(A, mv(A, x)) + mv_t(C, mv(C, x))))
                    x = x + mv(M_inv, r - Mx)
                Cx = mv(C, x)
                s = torch.clamp_min(d - Cx - z / rho, 0.0)
                y = y + rho * (mv(A, x) - b)
                z = torch.clamp_min(z + rho * (Cx - d + s), 0.0)
            it += settings.check_interval

            # PIQP criteria 13a-c, reduced over the blocks.
            Px, Ax, Cx = mv(Pm, x), mv(A, x), mv(C, x)
            Aty, Ctz = psum(mv_t(A, y), mv_t(C, z))
            norms = pmax(torch.stack([inf_norm(v) for v in (
                Ax - b, Cx - d + s, Ax, b, Cx, d, s)]))
            res_prim = norms[:2].amax(0)
            res_dual = inf_norm(Px + Aty + Ctz + q)
            max_prim = norms[2:].amax(0)
            max_dual = torch.stack([inf_norm(Px), inf_norm(Aty),
                                    inf_norm(Ctz), inf_norm(q)]).amax(0)
            eps_prim_t = settings.eps_abs + settings.eps_rel * max_prim
            eps_dual_t = settings.eps_abs + settings.eps_rel * max_dual
            now_conv = (res_prim < eps_prim_t) & (res_dual < eps_dual_t)
            status = status.masked_fill(running & now_conv, int(Status.SOLVED))
            if settings.check_infeasibility:
                status = _certificates(
                    settings, status, running, x, y, z, x_in, y_in, z_in, Px,
                    Aty, Ctz, Ax, Cx, q, b, d, prev, res_prim, res_dual,
                    eps_prim_t, eps_dual_t, psum, pmax)
                prev = {"Px": Px, "Aty": Aty, "Ctz": Ctz, "Ax": Ax, "Cx": Cx}
            newly = running & (status != Status.RUNNING)
            iters = torch.where(newly, torch.tensor(it, dtype=torch.int32,
                                                    device=dev), iters)
            rp_out = torch.where(running, res_prim, rp_out)
            rd_out = torch.where(running, res_dual, rd_out)
            if hist is not None:
                idx = it // settings.check_interval - 1
                hist["res_prim"][idx] = res_prim
                hist["res_dual"][idx] = res_dual
                hist["rho"][idx] = rho

            if settings.adaptive_rho:
                num = res_prim * max_dual
                den = res_dual * max_prim
                ratio = num / torch.where(den == 0, torch.ones_like(den), den)
                inv = 1.0 / torch.where(ratio == 0, torch.ones_like(ratio),
                                        ratio)
                trip = (running & ratio.isfinite() & (den != 0)
                        & ((ratio > settings.tau) | (inv > settings.tau)))
                rho_new = torch.clamp(
                    rho * torch.sqrt(torch.sqrt(
                        torch.where(trip, ratio, torch.ones_like(ratio)))),
                    settings.rho_min, settings.rho_max)
                rho = torch.where(trip, rho_new, rho)

    status = status.masked_fill(status == Status.RUNNING,
                                int(Status.MAX_ITERATIONS))
    y = all_gather_cat(y, group)[:me_orig]
    s = all_gather_cat(s, group)[:mi_orig]
    z = all_gather_cat(z, group)[:mi_orig]
    info = ProxQPInfo(converged=status == Status.SOLVED, iterations=iters,
                      res_prim=rp_out, res_dual=rd_out, rho=rho,
                      status=status, history=hist)
    return ProxQPSolution(x=x, s=s, y=y, z=z, info=info)


def _certificates(settings, status, running, x, y, z, x_in, y_in, z_in, Px,
                  Aty, Ctz, Ax, Cx, q, b, d, prev, res_prim, res_dual,
                  eps_prim_t, eps_dual_t, psum, pmax):
    """The split-form Farkas certificates (models/proxqp.py: _certificates)
    with the row-space reductions over the blocks."""
    eps_pi, eps_di = settings.eps_prim_inf, settings.eps_dual_inf
    dy, dz, dx = y - y_in, z - z_in, x - x_in
    n_dy, n_dz, n_dax, n_y, n_z = pmax(torch.stack([inf_norm(v) for v in (
        dy, dz, Ax - prev["Ax"], y, z)]))
    ndyz = torch.maximum(n_dy, n_dz)
    stat = inf_norm((Aty - prev["Aty"]) + (Ctz - prev["Ctz"]))
    ndx = inf_norm(dx)
    # The gap and the counts of sign-failing rows (exact in floating point)
    # in one collective.
    gap, sign_bad, cdx_bad = psum(torch.stack([
        (b * dy).sum() + (d * dz).sum(),
        (dz < -(eps_pi * ndyz)).to(x.dtype).sum(),
        (Cx - prev["Cx"] > eps_di * ndx).to(x.dtype).sum()]))
    prim_inf = ((ndyz > 0) & (stat <= eps_pi * ndyz)
                & (gap <= -eps_pi * ndyz) & (sign_bad == 0))
    dual_inf = ((ndx > 0)
                & (inf_norm(Px - prev["Px"]) <= eps_di * ndx)
                & (n_dax <= eps_di * ndx)
                & (cdx_bad == 0)
                & ((q * dx).sum() <= -eps_di * ndx))
    noise = 16 * torch.finfo(x.dtype).eps
    yz_scale = torch.clamp(torch.maximum(n_y, n_z), min=1.0)
    prim_inf &= (res_prim > 10 * eps_prim_t) & (ndyz > noise * yz_scale)
    dual_inf &= (res_dual > 10 * eps_dual_t) & (
        ndx > noise * torch.clamp(inf_norm(x), min=1.0))
    overridable = running & (status == Status.RUNNING)
    status = status.masked_fill(overridable & prim_inf,
                                int(Status.PRIMAL_INFEASIBLE))
    return status.masked_fill(overridable & dual_inf & ~prim_inf,
                              int(Status.DUAL_INFEASIBLE))
