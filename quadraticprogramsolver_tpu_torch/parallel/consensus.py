"""Block-split distributed solve (the model-parallel axis), alone or with
fleet sharding on a 2-D mesh (counterpart of the JAX package's
parallel/consensus.py; BASELINE config 5 is the combined case).

One dense box-form QP has its constraint rows split over the mesh's "blocks"
axis; the exact OSQP iteration of models/admm.py runs on every rank with
explicit collectives over that axis's group:

  * KKT normal matrix:  M = P + sigma*I + rho * psum_blocks(A_d' A_d)
  * KKT right-hand side: sigma*x - q + psum_blocks(A_d'(rho*z_d - y_d))
  * dual residual:       ||Px + q + psum_blocks(A_d' y_d)||_inf
  * primal residual / norms: per-lane inf-norms reduced with pmax

where psum is ``all_reduce(SUM)`` and pmax ``all_reduce(MAX)`` on the axis's
group. x stays replicated over the blocks: every rank computes the same
x-update from the same reduced sums. The JAX ``while_loop`` is a host loop
over checks whose flags agree over the block group (core/lockstep.py); on a
2-D mesh each fleet shard runs its own count of checks, as a ``shard_map``
loop does. M's inverse is ``spd_inverse``: on a card, row 2's sweep at
n % 128 == 0 with at least 4 lanes a rank.

Polish (MINRES on the masked KKT with psum'd inner products), vector rho
(weights from each row's own bounds), Anderson (split buffers: x-part
replicated, w = z + y/rho row-split, the Gram psum'd), the OSQP section 3.4
certificates and ``record_history`` all run distributed, as in JAX.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.lockstep import lockstep, read_flags
from ..core.problem import QP, pad_qp
from ..core.settings import RHO_MAX, RHO_MIN, Settings
from ..core.state import SolveInfo, Solution, Status
from ..models.anderson import aa_gamma
from ..models.kkt import _minres
from ..ops.linalg import (add_scaled_identity, fp32_products, inf_norm, mm,
                          mv, mv_t, spd_inverse, sym)
from .mesh import all_gather_cat, axis, rank_device, reducer

BLOCK_AXIS = "blocks"
FLEET_AXIS = "qp"


def pad_rows_for_mesh(qp: QP, n_shards: int) -> QP:
    """Pad constraint rows to a multiple of the block-mesh axis with
    inactive rows."""
    m_pad = -(-qp.m // n_shards) * n_shards
    return qp if m_pad == qp.m else pad_qp(qp, qp.n, m_pad)


def solve_block_split(qp: QP, settings: Settings = Settings(),
                      mesh=None) -> Solution:
    """Solve one large dense QP with its constraint rows split over a 1-D
    mesh (default: every rank of the world, on the cards). Every rank passes
    the whole QP and gets the whole Solution back."""
    if qp.batch_shape:
        raise ValueError(
            "solve_block_split takes a single (unbatched) QP; use "
            "solve_fleet_block_split for a fleet on a 2-D mesh")
    if mesh is None:
        from .mesh import make_mesh

        mesh = make_mesh((dist.get_world_size(),), (BLOCK_AXIS,))
    batched = QP(*(t[None] for t in qp.tensors()))
    sol = _solve_impl(batched, settings, mesh, None, mesh.mesh_dim_names[0])
    # History leaves are (num_checks, 1): batch on axis 1, unlike every
    # other Solution leaf; drop their batch axis separately.
    history = sol.info.history
    if history is not None:
        history = {k: v[:, 0] for k, v in history.items()}
    info = sol.info
    return Solution(
        x=sol.x[0], z=sol.z[0], y=sol.y[0],
        info=SolveInfo(status=info.status[0], iterations=info.iterations[0],
                       res_prim=info.res_prim[0], res_dual=info.res_dual[0],
                       rho=info.rho[0], objective=info.objective[0],
                       history=history))


def solve_fleet_block_split(qp: QP, settings: Settings = Settings(),
                            mesh=None) -> Solution:
    """BASELINE config 5: the fleet split over mesh axis 0 (data parallel),
    each QP's constraint rows over mesh axis 1 (model parallel). The
    default mesh puts every rank on the fleet axis, one block each."""
    if len(qp.batch_shape) != 1:
        raise ValueError("expected one fleet axis; got batch shape "
                         f"{qp.batch_shape}")
    if mesh is None:
        from .mesh import make_mesh

        mesh = make_mesh((dist.get_world_size(), 1), (FLEET_AXIS, BLOCK_AXIS))
    fa, ba = mesh.mesh_dim_names
    _, n_fleet, _ = axis(mesh, fa)
    if qp.batch_shape[0] % n_fleet:
        raise ValueError(
            f"fleet size {qp.batch_shape[0]} not divisible by mesh axis "
            f"{n_fleet}")
    return _solve_impl(qp, settings, mesh, fa, ba)


@fp32_products()
def _solve_impl(qp: QP, settings: Settings, mesh, fleet_axis, block_axis):
    """The distributed loop on this rank's (lanes, row block); every rank
    returns the whole (gathered) Solution."""
    rb, n_shards, bgroup = axis(mesh, block_axis)
    m_orig = qp.m
    qp = pad_rows_for_mesh(qp, n_shards)
    dev = rank_device(mesh)
    batch = qp.batch_shape
    lanes = slice(None)
    fgroup = None
    if fleet_axis is not None:
        rf, n_fleet, fgroup = axis(mesh, fleet_axis)
        per = batch[0] // n_fleet
        lanes = slice(rf * per, (rf + 1) * per)
    m_loc = qp.m // n_shards
    rows = slice(rb * m_loc, (rb + 1) * m_loc)

    def local(t, base, row_axis=None):
        t = t.expand(batch + tuple(t.shape[-base:]))[lanes]
        if row_axis is not None:
            t = t[..., rows, :] if row_axis == -2 else t[..., rows]
        return t.to(dev).contiguous()

    Pm = local(qp.P, 2)
    q = local(qp.q, 1)
    A = local(qp.A, 2, -2)
    l = local(qp.l, 1, -1)
    u = local(qp.u, 1, -1)
    dt = Pm.dtype
    Bb, n = q.shape
    sigma = settings.sigma_for(dt)
    alpha, alpha1 = settings.alpha, 1.0 - settings.alpha
    kw = dict(dtype=dt, device=dev)
    zero = torch.zeros((), **kw)

    # Maxima reduced together are exact; a check's go in one collective.
    psum = reducer(bgroup, dist.ReduceOp.SUM)
    pmax = reducer(bgroup, dist.ReduceOp.MAX)

    # Vector rho (OSQP's scheme, models/kkt.py: row_weights): equality rows
    # get rho * rho_eq_scale; the weights come from each row's own bounds,
    # so every rank computes its slice with no communication.
    w = None
    if settings.rho_eq_scale != 1.0:
        tol_eq = 1e-9 * torch.clamp(u.abs(), min=1.0)
        is_eq = l.isfinite() & u.isfinite() & ((u - l).abs() <= tol_eq)
        w = torch.where(is_eq, zero + settings.rho_eq_scale, zero + 1.0)

    def rho_rows(rho):
        r = rho[:, None]
        return r if w is None else r * w

    def factor(rho):
        Aw = A if w is None else A * w[..., None]
        AtA = psum(mm(Aw.transpose(-1, -2), A))
        M = add_scaled_identity(sym(Pm) + rho[:, None, None] * sym(AtA), sigma)
        return spd_inverse(M)

    def kkt_solve(M_inv, rho_row, x, z, y):
        b = sigma * x - q + psum(mv_t(A, rho_row * z - y))
        xx = mv(M_inv, b)
        for _ in range(settings.kkt_refinement_steps):
            Mxx = (mv(Pm, xx) + sigma * xx
                   + psum(mv_t(A, rho_row * mv(A, xx))))
            xx = xx + mv(M_inv, b - Mxx)
        return xx, mv(A, xx)

    x = torch.zeros((Bb, n), **kw)
    z = torch.zeros((Bb, m_loc), **kw)
    y = torch.zeros((Bb, m_loc), **kw)
    rho = torch.full((Bb,), settings.rho, **kw)
    rho_cand = rho.clone()
    M_inv = factor(rho)
    status = torch.zeros((Bb,), dtype=torch.int32, device=dev)
    iters = torch.zeros((Bb,), dtype=torch.int32, device=dev)
    rp = torch.full((Bb,), float("inf"), **kw)
    rd = torch.full((Bb,), float("inf"), **kw)
    mem = settings.anderson_memory
    aa = None
    if mem > 0:
        # Anderson history, stored split like the iterates: the x-part
        # replicated over the blocks, the w = z + y/rho part row-split.
        aa = {"Sx": torch.zeros((Bb, mem, n), **kw),
              "Fx": torch.zeros((Bb, mem, n), **kw),
              "Sw": torch.zeros((Bb, mem, m_loc), **kw),
              "Fw": torch.zeros((Bb, mem, m_loc), **kw),
              "px": torch.zeros((Bb, n), **kw), "fx": torch.zeros((Bb, n), **kw),
              "pw": torch.zeros((Bb, m_loc), **kw),
              "fw": torch.zeros((Bb, m_loc), **kw),
              "count": torch.zeros((Bb,), dtype=torch.int32, device=dev)}
    hist = None
    if settings.record_history:
        hist = {k: torch.full((settings.num_checks, Bb), float("inf"), **kw)
                for k in ("res_prim", "res_dual", "rho")}
    max_total = settings.num_checks * settings.check_interval
    it = 0
    with lockstep(bgroup):
        while it < max_total:
            running = status == Status.RUNNING
            trip = None
            flags = [running.any()]
            if settings.adaptive_rho:
                f = settings.rho_factor
                trip = running & ((rho_cand * f < rho) | (rho_cand > f * rho))
                flags.append(trip.any())
            flags = read_flags(torch.stack(flags))
            if not flags[0]:
                break
            if trip is not None:
                rho = torch.where(trip, rho_cand, rho)
                if flags[1]:
                    M_inv = factor(rho)
                if aa is not None:
                    # A re-adopted rho changes the w = z + y/rho encoding:
                    # the lane's history restarts (models/anderson.py).
                    m3 = trip[:, None, None]
                    for k in ("Sx", "Fx", "Sw", "Fw"):
                        aa[k] = torch.where(m3, zero, aa[k])
                    aa["count"] = aa["count"].masked_fill(trip, 0)

            active = running[:, None]
            rho_row = rho_rows(rho)
            x_start, z_start, y_start = x, z, y
            xp, zp = x, z
            for _ in range(settings.check_interval):
                xx, zz = kkt_solve(M_inv, rho_row, x, z, y)
                xp, zp = x, z
                x_new = alpha * xx + alpha1 * xp
                z_new = torch.minimum(torch.maximum(
                    alpha * zz + alpha1 * zp + y / rho_row, l), u)
                y_new = y + rho_row * (alpha * zz + alpha1 * zp - z_new)
                x = torch.where(active, x_new, xp)
                z = torch.where(active, z_new, zp)
                y = torch.where(active, y_new, y)
            it += settings.check_interval

            aa_accept = None
            if aa is not None:
                x, z, y, prods, aa, aa_accept = _aa_step(
                    settings, aa, running, rho_row, x_start, z_start, y_start,
                    x, z, y, Pm, q, A, l, u, psum, pmax)
                Ax, Px, ATy = prods
            else:
                Ax = mv(A, x)
                Px = mv(Pm, x)
                ATy = psum(mv_t(A, y))
            res_prim, ax_n, z_n, dx_n, dz_n = pmax(
                inf_norm(Ax - z), inf_norm(Ax), inf_norm(z), inf_norm(x - xp),
                inf_norm(z - zp))
            res_dual = inf_norm(Px + q + ATy)
            max_prim = torch.maximum(ax_n, z_n)
            max_dual = torch.maximum(torch.maximum(inf_norm(Px), inf_norm(ATy)),
                                     inf_norm(q))

            if settings.adaptive_rho:
                den = res_dual * max_prim
                cand = torch.clamp(
                    rho * torch.sqrt(res_prim * max_dual
                                     / torch.where(den == 0, zero + 1.0, den)),
                    RHO_MIN, RHO_MAX)
                ok = cand.isfinite() & (den != 0) & (cand > 0)
                rho_cand = torch.where(running & ok, cand, rho_cand)

            eps_prim = settings.eps_abs + settings.eps_rel * max_prim
            eps_dual = settings.eps_abs + settings.eps_rel * max_dual
            solved = (res_prim < eps_prim) & (res_dual < eps_dual)
            ulp = 8 * torch.finfo(dt).eps
            fp = ((dx_n <= settings.eps_admm
                   + ulp * torch.clamp(inf_norm(x), min=1.0))
                  & (dz_n <= settings.eps_admm
                     + ulp * torch.clamp(z_n, min=1.0)))
            if aa_accept is not None:
                # Accepted AA lanes compare x against the plain chunk's
                # penultimate iterate, a point of another map.
                fp &= ~aa_accept
            status = status.masked_fill(running & solved, int(Status.SOLVED))
            status = status.masked_fill(running & fp, int(Status.SOLVED_ADMM))
            if settings.check_infeasibility:
                status = _certificates(
                    settings, status, running, x, y, x_start, y_start, Pm, q,
                    A, l, u, res_prim, res_dual, eps_prim, eps_dual, psum,
                    pmax)
            newly = running & (status != Status.RUNNING)
            iters = iters.masked_fill(newly, it)
            rp = torch.where(running, res_prim, rp)
            rd = torch.where(running, res_dual, rd)
            if hist is not None:
                # rho recorded is the chunk's (post-adoption) value; the
                # residuals are the reduced ones every block rank holds.
                idx = it // settings.check_interval - 1
                hist["res_prim"][idx] = res_prim
                hist["res_dual"][idx] = res_dual
                hist["rho"][idx] = rho

        exhausted = status == Status.RUNNING
        status = status.masked_fill(exhausted, int(Status.MAX_ITERATIONS))
        iters = iters.masked_fill(exhausted, it)
        if settings.polish_iterations > 0:
            x, y = _polish_block(settings, x, z, y, Pm, q, A, l, u, psum, pmax)

    objective = 0.5 * (x * mv(Pm, x)).sum(-1) + (q * x).sum(-1)
    # The row-split duals are gathered over the blocks, then every per-lane
    # tensor over the fleet; the duals come back at the caller's constraint
    # count (padded rows carry z = y = 0 and never bind).
    z = all_gather_cat(z, bgroup, -1)[..., :m_orig]
    y = all_gather_cat(y, bgroup, -1)[..., :m_orig]
    out = [x, z, y, status, iters, rp, rd, rho, objective]
    if fgroup is not None:
        out = [all_gather_cat(t, fgroup, 0) for t in out]
        if hist is not None:
            hist = {k: all_gather_cat(v, fgroup, 1) for k, v in hist.items()}
    x, z, y, status, iters, rp, rd, rho, objective = out
    info = SolveInfo(status=status, iterations=iters, res_prim=rp,
                     res_dual=rd, rho=rho, objective=objective, history=hist)
    return Solution(x=x, z=z, y=y, info=info)


def _aa_step(settings, aa, running, rho_row, x_start, z_start, y_start, x, z,
             y, Pm, q, A, l, u, psum, pmax):
    """The guarded Anderson step in the split coordinates (x replicated,
    w = z + y/rho row-split): the Gram and its right-hand side psum the w
    contribution, so every block rank solves the same M x M system (math:
    models/anderson.py). Returns (x, z, y, (Ax, Px, A'y), aa, accept)."""
    mem = settings.anderson_memory
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    w_in = z_start + y_start / rho_row
    w_pl = z + y / rho_row
    fx = x - x_start
    fw = w_pl - w_in
    have = aa["count"] >= 1
    slot = torch.where(have, torch.remainder(aa["count"] - 1, mem),
                       torch.zeros_like(aa["count"]))
    onehot = torch.arange(mem, device=x.device)[None, :] == slot[:, None]
    push = (onehot & have[:, None])[..., None]
    Sx = torch.where(push, (x_start - aa["px"])[:, None, :], aa["Sx"])
    Fx = torch.where(push, (fx - aa["fx"])[:, None, :], aa["Fx"])
    Sw = torch.where(push, (w_in - aa["pw"])[:, None, :], aa["Sw"])
    Fw = torch.where(push, (fw - aa["fw"])[:, None, :], aa["Fw"])
    Gw, rw = psum(mm(Fw, Fw.transpose(-1, -2)), mv(Fw, fw))
    G = mm(Fx, Fx.transpose(-1, -2)) + Gw
    rhs_g = mv(Fx, fx) + rw
    gamma = aa_gamma(G, rhs_g, mem, settings.anderson_reg, x.dtype)
    x_a = x - mv_t(Sx + Fx, gamma)
    w_a = w_pl - mv_t(Sw + Fw, gamma)
    z_a = torch.minimum(torch.maximum(w_a, l), u)
    y_a = rho_row * (w_a - z_a)

    def margin(xv, zv, yv):
        Axv, Pxv, ATyv = mv(A, xv), mv(Pm, xv), psum(mv_t(A, yv))
        rpv, a_n, z_n = pmax(inf_norm(Axv - zv), inf_norm(Axv), inf_norm(zv))
        rdv = inf_norm(Pxv + q + ATyv)
        mpv = torch.maximum(a_n, z_n)
        mdv = torch.maximum(torch.maximum(inf_norm(Pxv), inf_norm(ATyv)),
                            inf_norm(q))
        marg = torch.maximum(
            rpv / (settings.eps_abs + settings.eps_rel * mpv),
            rdv / (settings.eps_abs + settings.eps_rel * mdv))
        return marg, (Axv, Pxv, ATyv)

    m_p, pr_p = margin(x, z, y)
    m_a, pr_a = margin(x_a, z_a, y_a)
    accept = running & have & m_a.isfinite() & (m_a < m_p)
    rejected = running & have & ~accept
    sel = accept[:, None]
    x = torch.where(sel, x_a, x)
    z = torch.where(sel, z_a, z)
    y = torch.where(sel, y_a, y)
    prods = tuple(torch.where(sel, a, p) for a, p in zip(pr_a, pr_p))
    r3 = rejected[:, None, None]
    a2 = running[:, None]
    aa = {"Sx": torch.where(r3, zero, Sx), "Fx": torch.where(r3, zero, Fx),
          "Sw": torch.where(r3, zero, Sw), "Fw": torch.where(r3, zero, Fw),
          "px": torch.where(a2, x_start, aa["px"]),
          "fx": torch.where(a2, fx, aa["fx"]),
          "pw": torch.where(a2, w_in, aa["pw"]),
          "fw": torch.where(a2, fw, aa["fw"]),
          "count": torch.where(running, aa["count"] + 1,
                               aa["count"]).masked_fill(rejected, 1)}
    return x, z, y, prods, aa, accept


def _certificates(settings, status, running, x, y, x_start, y_start, Pm, q,
                  A, l, u, res_prim, res_dual, eps_prim, eps_dual, psum,
                  pmax):
    """OSQP section 3.4 iterate-difference certificates with the row-space
    reductions (norms, the support function, the every-row test) over the
    blocks: models/admm.py's math and gates. A certificate outranks the
    fixed-point flag but not SOLVED."""
    dt = x.dtype
    zero = torch.zeros((), dtype=dt, device=x.device)
    inf = torch.tensor(float("inf"), dtype=dt, device=x.device)
    eps_p, eps_d = settings.eps_prim_inf, settings.eps_dual_inf
    dy = y - y_start                      # row-split
    dx = x - x_start                      # replicated
    ndy, y_n = pmax(inf_norm(dy), inf_norm(y))
    pos = torch.clamp(dy, min=0.0)
    neg = torch.clamp(dy, max=0.0)
    tol = (eps_p * ndy)[:, None]
    fin_l, fin_u = l.isfinite(), u.isfinite()
    term_u = torch.where(fin_u, u * pos, torch.where(pos > tol, inf, zero))
    term_l = torch.where(fin_l, l * neg, torch.where(neg < -tol, inf, zero))
    ndx = inf_norm(dx)
    Adx = mv(A, dx)
    tol_d = (eps_d * ndx)[:, None]
    ok_rows = torch.where(
        fin_l & fin_u, Adx.abs() <= tol_d,
        torch.where(fin_l, Adx >= -tol_d,
                    torch.where(fin_u, Adx <= tol_d, torch.ones_like(fin_l))))
    # The support, A'dy and the count of failing rows (exact in floating
    # point) in one collective.
    support, Atdy, bad = psum((term_u + term_l).sum(-1), mv_t(A, dy),
                              (~ok_rows).to(dt).sum(-1))
    all_ok = bad == 0
    prim_inf = ((ndy > 0) & (inf_norm(Atdy) <= eps_p * ndy)
                & (support <= -eps_p * ndy))
    dual_inf = ((ndx > 0) & (inf_norm(mv(Pm, dx)) <= eps_d * ndx)
                & ((q * dx).sum(-1) <= -eps_d * ndx) & all_ok)
    noise = 16 * torch.finfo(dt).eps
    prim_inf &= (res_prim > 10 * eps_prim) & (
        ndy > noise * torch.clamp(y_n, min=1.0))
    dual_inf &= (res_dual > 10 * eps_dual) & (
        ndx > noise * torch.clamp(inf_norm(x), min=1.0))
    overridable = running & (status != Status.SOLVED)
    status = status.masked_fill(overridable & prim_inf,
                                int(Status.PRIMAL_INFEASIBLE))
    return status.masked_fill(overridable & dual_inf & ~prim_inf,
                              int(Status.DUAL_INFEASIBLE))


def _polish_block(settings, x, z, y, Pm, q, A, l, u, psum, pmax):
    """Distributed polish (models/polish.py: polish_minres with the rows
    split): A applies locally, A' contributions and every MINRES inner
    product psum over the blocks, and the acceptance metric pmaxes the
    local bound violations. The Lanczos recurrence sees only reduced
    scalars, so every block rank computes the same polished x."""
    dt = x.dtype
    n = Pm.shape[-1]
    delta = settings.delta
    zero = torch.zeros((), dtype=dt, device=x.device)
    one = zero + 1.0
    Ax = mv(A, x)
    # Active set: dual sign and primal proximity (polish.py: _active_set).
    c = 10.0 * torch.clamp(pmax(inf_norm(Ax - z)), min=settings.eps_abs)[:, None]
    low_active = (y < 0) & l.isfinite() & (z - l <= c * (1.0 + l.abs()))
    up_active = (y > 0) & u.isfinite() & (u - z <= c * (1.0 + u.abs()))
    act_rows = low_active | up_active
    g = torch.where(low_active, l, zero) + torch.where(up_active, u, zero)
    r_diag = torch.where(act_rows, one * delta, one)

    def apply_K(v):
        v1, v2 = v[..., :n], v[..., n:]
        top = (mv(Pm, v1) + delta * v1
               + psum(mv_t(A, torch.where(act_rows, v2, zero))))
        bot = torch.where(act_rows, mv(A, v1), zero) - r_diag * v2
        return torch.cat([top, bot], dim=-1)

    def apply_K_exact(v):
        v1, v2 = v[..., :n], v[..., n:]
        top = mv(Pm, v1) + psum(mv_t(A, torch.where(act_rows, v2, zero)))
        bot = (torch.where(act_rows, mv(A, v1), zero)
               - torch.where(act_rows, zero, v2))
        return torch.cat([top, bot], dim=-1)

    d1 = torch.diagonal(Pm, dim1=-2, dim2=-1) + delta
    d1_inv = torch.where(d1 > 0, 1.0 / d1, one)

    def precond(v):
        return torch.cat([d1_inv * v[..., :n], v[..., n:] / r_diag], dim=-1)

    def vdot(a, b):
        return ((a[..., :n] * b[..., :n]).sum(-1)
                + psum((a[..., n:] * b[..., n:]).sum(-1)))

    def kkt_err(xv, yv):
        Axv = mv(A, xv)
        dual = inf_norm(mv(Pm, xv) + q + psum(mv_t(A, yv)))
        viol = pmax(inf_norm(Axv - torch.minimum(torch.maximum(Axv, l), u)))
        return torch.maximum(dual, viol)

    b = torch.cat([-q, g], dim=-1)
    v = torch.cat([x, torch.where(act_rows, y, zero)], dim=-1)
    # Refinement sweeps against the unregularized system, as
    # models/polish.py: polish_minres.
    for _ in range(max(1, settings.polish_iterations)):
        r = b - apply_K_exact(v)
        v = v + _minres(apply_K, precond, r, torch.zeros_like(b), abs_tol=0.0,
                        max_iterations=settings.polish_max_krylov, vdot=vdot,
                        rel_tol=settings.polish_eps)
    px, pn = v[..., :n], v[..., n:]
    finite = (px.isfinite().all(-1)
              & (psum((~pn.isfinite()).to(dt).sum(-1)) == 0))
    accept = (kkt_err(px, pn) < kkt_err(x, y)) & finite
    return (torch.where(accept[:, None], px, x),
            torch.where(accept[:, None], pn, y))
