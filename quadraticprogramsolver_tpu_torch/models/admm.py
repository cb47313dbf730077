"""Batched OSQP-style ADMM solver (counterpart of the JAX package's
models/admm.py).

Solves fleets of box-constrained QPs  min 0.5 x'Px + q'x  s.t.  l <= Ax <= u
with the operator-splitting iteration

    (xx, zz) <- KKT solve                 (kkt.py)
    x <- alpha*xx + (1-alpha)*x
    z <- clip(alpha*zz + (1-alpha)*z + y/rho, l, u)
    y <- y + rho*(alpha*zz + (1-alpha)*z_prev - z)

with adaptive rho (square-root residual-ratio rule, clipped to [1e-3, 1e6],
5x refactor hysteresis), the primal/dual and fixed-point termination tests,
and the OSQP section 3.4 infeasibility certificates.

The JAX package's ``while_loop`` becomes a host loop over check intervals:
each pass runs one chunk of ``check_interval`` iterations (one kernel launch
on the fused path), one convergence check on the device, and ONE
device-to-host sync that reads "any lane still running" together with "any
lane's rho tripped" (``_solve_core.syncs`` counts them). Lanes that finished
are frozen by masking. The KKT backend (models/kkt.py) is CHOLESKY for dense
problems or CG, the matrix-free path of a :class:`~..core.sparse_problem.
SparseQP`; CG's inner loop reads its own flag once per step (``kkt._pcg``).

``solve(..., scaling=)`` takes a problem pre-scaled by Ruiz equilibration
(models/scaling.py: ``equilibrate_sparse_host``): warm starts and the
solution are in the original space, and termination runs on unscaled
residuals (``term_scale``) while rho adapts on the scaled ones.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.problem import QP, pad_qp
from ..core.settings import (RHO_MAX, RHO_MIN, KKTBackendKind, Settings,
                             chunk_precision)
from ..core.state import SolveInfo, Solution, SolverState, Status
from ..ops.linalg import fp32_products, inf_norm, kernel_dtype_ok
from . import kkt as kkt_mod
from .plan import check_require_fused, plan as plan_fn


def _as_tensor(v, qp: QP):
    return torch.as_tensor(v, dtype=qp.dtype, device=qp.device).contiguous()


def _init_state(qp: QP, settings: Settings, backend, x0=None, z0=None,
                y0=None, rho0=None) -> SolverState:
    batch = qp.batch_shape
    kw = dict(dtype=qp.dtype, device=qp.device)
    x = torch.zeros(batch + (qp.n,), **kw) if x0 is None else _as_tensor(x0, qp)
    z = torch.zeros(batch + (qp.m,), **kw) if z0 is None else _as_tensor(z0, qp)
    y = torch.zeros(batch + (qp.m,), **kw) if y0 is None else _as_tensor(y0, qp)
    rho = (torch.full(batch, settings.rho, **kw) if rho0 is None
           else _as_tensor(rho0, qp).expand(batch).clone())
    cache = backend.init(qp, rho, settings.sigma_for(qp.dtype), settings)
    products = None
    if settings.check_infeasibility:
        # Products at the start iterate, the base of the first check's
        # certificate deltas (P dx = Px - Px_prev, by linearity).
        products = {"Px": qp.matvec_P(x), "Ax": qp.matvec_A(x),
                    "ATy": qp.matvec_At(y)}
    zi = torch.zeros(batch, dtype=torch.int32, device=qp.device)
    return SolverState(
        x=x, z=z, y=y, rho=rho, rho_cand=rho.clone(), status=zi,
        iterations=zi.clone(),
        res_prim=torch.full(batch, float("inf"), **kw),
        res_dual=torch.full(batch, float("inf"), **kw),
        iteration=0, kkt_cache=cache, products=products)


def _fused_chunk_ok(qp: QP, settings: Settings) -> bool:
    return (
        settings.fused_chunk
        and qp.is_dense
        and kernel_dtype_ok(qp.dtype, qp.device)
        and len(qp.batch_shape) == 1
        and qp.n % 128 == 0 and qp.n > 0
        and qp.m % 128 == 0 and qp.m > 0
        and kkt_mod.resolve_backend(settings.kkt_backend, qp)
        is KKTBackendKind.CHOLESKY
    )


def _run_chunk(qp: QP, settings: Settings, backend, state: SolverState):
    """check_interval masked ADMM iterations.

    Returns (x, z, y, xp, zp, cache, chunk_prods): cache is the backend's
    cache after the chunk (CG's carries its warm start xx), chunk_prods is
    (Ax, ATy) from the fused kernel, or None on the torch path (the check
    computes them there).
    """
    rho_row = kkt_mod.rho_rows(qp, state.rho, settings).expand(
        qp.batch_shape + (qp.m,)).contiguous()
    if _fused_chunk_ok(qp, settings):
        from ..ops.fused_admm import fused_admm_chunk, fused_admm_chunk_minv

        c = state.kkt_cache
        active = state.status == Status.RUNNING
        B = state.x.shape[0]
        lanes = settings.chunk_lanes if B % settings.chunk_lanes == 0 else 1
        if settings.sigma_free_rhs:
            if "S" in c:  # slab_cache: G read as a window of the slab
                G, kw = c["S"], dict(slab=True)
            elif "Ghi" in c:  # split_cache: G as its bf16 halves
                G, kw = c["Ghi"], dict(Glo=c["Glo"])
            else:
                G, kw = c["G"], {}
            x, z, y, xp, zp, Ax, ATy = fused_admm_chunk(
                G, qp.A, c["g"], qp.l, qp.u, state.x, state.z, state.y,
                rho_row, active, K=settings.check_interval,
                alpha=settings.alpha, lanes=lanes,
                dot_precision=chunk_precision(settings, state.iteration), **kw)
        else:
            # The factor's sigma (the f32 floor applies to both).
            x, z, y, xp, zp, Ax, ATy = fused_admm_chunk_minv(
                c["M_inv"], qp.A, qp.P, qp.q, qp.l, qp.u, state.x, state.z,
                state.y, rho_row, active, K=settings.check_interval,
                alpha=settings.alpha, sigma=settings.sigma_for(qp.dtype),
                refine=settings.kkt_refinement_steps, lanes=lanes)
        return x, z, y, xp, zp, state.kkt_cache, (Ax, ATy)

    alpha, alpha1 = settings.alpha, 1.0 - settings.alpha
    active = (state.status == Status.RUNNING)[..., None]
    x, z, y, cache = state.x, state.z, state.y, state.kkt_cache
    xp, zp = x, z
    for _ in range(settings.check_interval):
        xx, zz, cache = backend.solve(cache, qp, x, z, y, state.rho, settings)
        xp, zp = x, z
        x_new = alpha * xx + alpha1 * xp
        z_new = torch.minimum(
            torch.maximum(alpha * zz + alpha1 * zp + y / rho_row, qp.l), qp.u)
        y_new = y + rho_row * (alpha * zz + alpha1 * zp - z_new)
        # Converged lanes freeze.
        x = torch.where(active, x_new, xp)
        z = torch.where(active, z_new, zp)
        y = torch.where(active, y_new, y)
    return x, z, y, xp, zp, cache, None


def _infeasibility_certificates(qp: QP, settings: Settings, dx, dy,
                                Pdx, Adx, ATdy):
    """OSQP section 3.4 iterate-difference certificates -> (prim, dual)."""
    eps_p, eps_d = settings.eps_prim_inf, settings.eps_dual_inf
    inf = torch.tensor(float("inf"), dtype=qp.dtype, device=qp.device)
    zero = torch.zeros((), dtype=qp.dtype, device=qp.device)

    ndy = inf_norm(dy)
    pos = torch.clamp(dy, min=0.0)
    neg = torch.clamp(dy, max=0.0)
    tol = (eps_p * ndy)[..., None]
    fin_l, fin_u = qp.l.isfinite(), qp.u.isfinite()
    term_u = torch.where(fin_u, qp.u * pos, torch.where(pos > tol, inf, zero))
    term_l = torch.where(fin_l, qp.l * neg, torch.where(neg < -tol, inf, zero))
    support = (term_u + term_l).sum(-1)
    prim_inf = ((ndy > 0) & (inf_norm(ATdy) <= eps_p * ndy)
                & (support <= -eps_p * ndy))

    ndx = inf_norm(dx)
    tol_d = (eps_d * ndx)[..., None]
    ok_rows = torch.where(
        fin_l & fin_u, Adx.abs() <= tol_d,
        torch.where(fin_l, Adx >= -tol_d,
                    torch.where(fin_u, Adx <= tol_d, torch.ones_like(fin_l))))
    dual_inf = ((ndx > 0) & (inf_norm(Pdx) <= eps_d * ndx)
                & ((qp.q * dx).sum(-1) <= -eps_d * ndx)
                & ok_rows.all(-1))
    return prim_inf, dual_inf


def _check_convergence(qp: QP, settings: Settings, state: SolverState,
                       x, z, y, xp, zp, term_scale=None,
                       chunk_prods=None) -> SolverState:
    """Residuals, adaptive-rho candidate and termination flags.

    Flag precedence as in the JAX package: the fixed-point flag (2) wins over
    primal/dual (3) when both pass in one check; a certificate (4/5) wins
    over the fixed point but not over 3.

    With ``term_scale`` (a ScalingData of a Ruiz-scaled problem, P' = cDPD,
    A' = EAD, x = Dx', y = Ey'/c) the termination tests run on the unscaled
    residuals E^{-1}(A'x' - z') and D^{-1}(P'x' + q' + A''y')/c, while rho
    adapts on the scaled ones (JAX admm.py:418-472). The certificates stay
    in the scaled space: infeasibility is invariant under diagonal scaling.
    """
    dt = qp.dtype
    if chunk_prods is None:
        Ax, ATy = qp.matvec_A(x), qp.matvec_At(y)
    else:
        Ax, ATy = chunk_prods
    Px = qp.matvec_P(x)

    if term_scale is None:
        def unsc_p(v):
            return v
        unsc_d = unsc_x = unsc_p
    else:
        e_inv = 1.0 / term_scale.e
        dc_inv = 1.0 / (term_scale.d * term_scale.c[..., None])

        def unsc_p(v):  # row-space (primal) vectors
            return v * e_inv

        def unsc_d(v):  # variable-space (dual) vectors
            return v * dc_inv

        def unsc_x(v):  # primal iterates and their deltas
            return v * term_scale.d

    res_prim = inf_norm(unsc_p(Ax - z))
    res_dual = inf_norm(unsc_d(Px + qp.q + ATy))
    max_prim = torch.maximum(inf_norm(unsc_p(Ax)), inf_norm(unsc_p(z)))
    max_dual = torch.maximum(
        torch.maximum(inf_norm(unsc_d(Px)), inf_norm(unsc_d(ATy))),
        inf_norm(unsc_d(qp.q)))
    active = state.status == Status.RUNNING

    rho_cand = state.rho_cand
    if settings.adaptive_rho:
        # rho adapts on the residuals of the space the iteration runs in.
        if term_scale is None:
            rp_s, rd_s, mp_s, md_s = res_prim, res_dual, max_prim, max_dual
        else:
            rp_s = inf_norm(Ax - z)
            rd_s = inf_norm(Px + qp.q + ATy)
            mp_s = torch.maximum(inf_norm(Ax), inf_norm(z))
            md_s = torch.maximum(torch.maximum(inf_norm(Px), inf_norm(ATy)),
                                 inf_norm(qp.q))
        num = rp_s * md_s
        den = rd_s * mp_s
        ratio = torch.sqrt(num / torch.where(den == 0, torch.ones_like(den), den))
        cand = torch.clamp(state.rho * ratio, RHO_MIN, RHO_MAX)
        ok = cand.isfinite() & (den != 0) & (cand > 0)
        rho_cand = torch.where(active & ok, cand, rho_cand)

    eps_prim = settings.eps_abs + settings.eps_rel * max_prim
    eps_dual = settings.eps_abs + settings.eps_rel * max_dual
    solved = (res_prim < eps_prim) & (res_dual < eps_dual)
    # Fixed-point threshold with a dtype-aware floor of 8 ulps of the
    # iterate scale (invisible in f64, the honest floor in f32).
    ulp = 8 * torch.finfo(dt).eps
    eps_x = settings.eps_admm + ulp * torch.clamp(inf_norm(unsc_x(x)), min=1.0)
    eps_z = settings.eps_admm + ulp * torch.clamp(inf_norm(unsc_p(z)), min=1.0)
    admm_fp = ((inf_norm(unsc_x(x - xp)) <= eps_x)
               & (inf_norm(unsc_p(z - zp)) <= eps_z))

    status = state.status
    status = status.masked_fill(active & solved, int(Status.SOLVED))
    status = status.masked_fill(active & admm_fp, int(Status.SOLVED_ADMM))
    if settings.check_infeasibility:
        prev = state.products
        dx, dy = x - state.x, y - state.y
        prim_inf, dual_inf = _infeasibility_certificates(
            qp, settings, dx, dy, Px - prev["Px"], Ax - prev["Ax"],
            ATy - prev["ATy"])
        # Anti-false-positive gates: far from the convergence threshold and
        # deltas above the iterate noise floor.
        noise = 16 * torch.finfo(dt).eps
        prim_inf &= (res_prim > 10 * eps_prim) & (
            inf_norm(dy) > noise * torch.clamp(inf_norm(y), min=1.0))
        dual_inf &= (res_dual > 10 * eps_dual) & (
            inf_norm(dx) > noise * torch.clamp(inf_norm(x), min=1.0))
        overridable = active & (status != Status.SOLVED)
        status = status.masked_fill(overridable & prim_inf,
                                    int(Status.PRIMAL_INFEASIBLE))
        status = status.masked_fill(overridable & dual_inf & ~prim_inf,
                                    int(Status.DUAL_INFEASIBLE))
    newly_done = active & (status != Status.RUNNING)
    iteration = state.iteration + settings.check_interval
    iterations = state.iterations.masked_fill(newly_done, iteration)
    products = None
    if state.products is not None:
        products = {"Px": Px, "Ax": Ax, "ATy": ATy}
    return dataclasses.replace(
        state, x=x, z=z, y=y, rho_cand=rho_cand, status=status,
        iterations=iterations,
        res_prim=torch.where(active, res_prim, state.res_prim),
        res_dual=torch.where(active, res_dual, state.res_dual),
        iteration=iteration, products=products)


def _rho_trips(settings: Settings, state: SolverState):
    """Lanes whose rho candidate left the [rho/f, f*rho] hysteresis band,
    or None when rho is static."""
    if not settings.adaptive_rho:
        return None
    f = settings.rho_factor
    active = state.status == Status.RUNNING
    return active & ((state.rho_cand * f < state.rho)
                     | (state.rho_cand > f * state.rho))


def _maybe_refactor(qp: QP, settings: Settings, backend, state: SolverState,
                    tripped, any_tripped: bool) -> SolverState:
    """Adopt tripped lanes' rho candidates and refresh the KKT cache.

    The JAX package's ``lax.cond(any(tripped))`` is the host ``if`` on
    ``any_tripped`` (read in the loop's one sync); a backend with a cheap
    refactor (CG's diagonal refresh) refreshes every chunk, as in JAX. Lanes
    that did not trip keep their rho, so refreshing the whole batch leaves
    their cache unchanged.
    """
    if not (any_tripped or backend.cheap_refactor):
        return state
    rho = torch.where(tripped, state.rho_cand, state.rho)
    cache = backend.refactor(state.kkt_cache, qp, rho,
                             settings.sigma_for(qp.dtype), settings)
    return dataclasses.replace(state, rho=rho, kkt_cache=cache)


def _solve_core(qp: QP, settings: Settings, x0, z0, y0, rho0,
                term_scale=None) -> Solution:
    if settings.sigma_free_rhs and kkt_mod.resolve_backend(
            settings.kkt_backend, qp) is not KKTBackendKind.CHOLESKY:
        raise ValueError(
            "sigma_free_rhs is a dense CHOLESKY-backend optimization; "
            "other backends build the RHS per-solve anyway")
    backend = kkt_mod.get_backend(settings.kkt_backend, qp)
    state = _init_state(qp, settings, backend, x0, z0, y0, rho0)
    max_iter = settings.num_checks * settings.check_interval
    while state.iteration < max_iter:
        tripped = _rho_trips(settings, state)
        flags = [(state.status == Status.RUNNING).any()]
        if tripped is not None:
            flags.append(tripped.any())
        flags = torch.stack(flags).tolist()  # the check's one host sync
        _solve_core.syncs += 1
        if not flags[0]:
            break
        if tripped is not None:
            state = _maybe_refactor(qp, settings, backend, state, tripped,
                                    flags[1])
        x, z, y, xp, zp, cache, prods = _run_chunk(qp, settings, backend,
                                                   state)
        state = dataclasses.replace(state, kkt_cache=cache)
        state = _check_convergence(qp, settings, state, x, z, y, xp, zp,
                                   term_scale, prods)

    exhausted = state.status == Status.RUNNING
    status = state.status.masked_fill(exhausted, int(Status.MAX_ITERATIONS))
    iterations = state.iterations.masked_fill(exhausted, state.iteration)
    x, y = state.x, state.y
    if state.products is not None:
        # Px was computed at the final check for this exact x.
        objective = 0.5 * (x * state.products["Px"]).sum(-1) + (qp.q * x).sum(-1)
    else:
        objective = qp.objective(x)
    info = SolveInfo(status=status, iterations=iterations,
                     res_prim=state.res_prim, res_dual=state.res_dual,
                     rho=state.rho, objective=objective)
    return Solution(x=x, z=state.z, y=y, info=info)


_solve_core.syncs = 0


def _solve_impl(qp, settings: Settings, x0, z0, y0, rho0,
                scaling=None) -> Solution:
    if scaling is None:
        return _solve_core(qp, settings, x0, z0, y0, rho0)
    from .scaling import scale_iterates, unscale_iterates

    scaling = scaling.to(qp.dtype, qp.device)
    xs, zs, ys = scale_iterates(
        scaling, *(None if v is None else _as_tensor(v, qp)
                   for v in (x0, z0, y0)))
    sol = _solve_core(qp, settings, xs, zs, ys, rho0, term_scale=scaling)
    x, z, y = unscale_iterates(scaling, sol.x, sol.z, sol.y)
    # The in-loop residuals are already unscaled (term_scale); the scaled
    # problem's objective is c times the original's.
    info = dataclasses.replace(sol.info,
                               objective=sol.info.objective / scaling.c)
    return Solution(x=x, z=z, y=y, info=info)


@fp32_products()
def solve(qp, settings: Settings = Settings(), x0=None, z0=None, y0=None,
          rho0=None, scaling=None) -> Solution:
    """Solve a (batched) box-constrained QP on the device its tensors are on.

    ``qp`` is a dense batched :class:`QP` or one large
    :class:`~..core.sparse_problem.SparseQP` (the matrix-free CG path).
    ``x0``/``z0``/``y0`` warm-start the iterates and ``rho0`` (scalar or
    per-lane) the penalty. ``scaling``: the ScalingData of a problem
    pre-scaled by Ruiz equilibration (``equilibrate_sparse_host`` then
    ``make_sparse_qp``); warm starts and the solution are in the original
    space and termination runs on unscaled residuals. A dense fleet that
    the fused chunk wants in 128-multiples is padded first (the inert
    padding of :func:`~..core.problem.pad_qp`; not with ``scaling``),
    solved, and sliced back. With ``settings.require_fused`` any requested
    kernel that would not run is an error (models/plan.py). Torch's
    products run in full FP32 inside (:func:`~..ops.linalg.fp32_products`).
    """
    if qp.is_dense:
        qp = QP(*(t.contiguous() for t in qp.tensors()))  # what the kernels take
    p = plan_fn(qp, settings)
    if settings.require_fused:
        check_require_fused(p, "ADMM")
    if p.padded is not None and scaling is None:
        n_pad, m_pad = p.padded

        def vpad(v, w):
            if v is None:
                return None
            v = _as_tensor(v, qp)
            return torch.nn.functional.pad(v, (0, w - v.shape[-1]))

        sol = _solve_core(pad_qp(qp, n_pad, m_pad), settings, vpad(x0, n_pad),
                          vpad(z0, m_pad), vpad(y0, m_pad), rho0)
        return Solution(x=sol.x[..., : qp.n], z=sol.z[..., : qp.m],
                        y=sol.y[..., : qp.m], info=sol.info)
    return _solve_impl(qp, settings, x0, z0, y0, rho0, scaling)


#: PyTorch runs eagerly; the alias keeps the JAX package's call sites.
solve_jit = solve
