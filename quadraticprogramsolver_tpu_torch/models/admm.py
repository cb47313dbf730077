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
lane's rho tripped" (``_solve_core.syncs`` counts them; in a distributed
solve the ranks agree on it, core/lockstep.py). Lanes that finished are
frozen by masking. In a torch.profiler trace each layer is a span
(utils/profiling.py): ``qps.solve`` around :func:`solve`, and ``qps.pad``,
``qps.factor``, ``qps.chunk``, ``qps.anderson``, ``qps.check``,
``qps.sync`` and ``qps.polish`` inside it. The KKT backend (models/kkt.py)
is CHOLESKY for dense problems or CG, the matrix-free path of a
:class:`~..core.sparse_problem.SparseQP`; CG's inner loop reads its own
flag once per step (``kkt._pcg``).

``solve(..., scaling=)`` takes a problem pre-scaled by Ruiz equilibration
(models/scaling.py: ``equilibrate_sparse_host``); ``Settings.scaling_iters``
equilibrates a dense fleet inside the solve (``equilibrate``, after the
auto-pad). Either way warm starts and the solution are in the original
space, and termination runs on unscaled residuals (``term_scale``) while rho
adapts on the scaled ones. ``Settings.anderson_memory`` adds a guarded
Anderson step at each check (models/anderson.py), ``polish_iterations`` an
active-set polish at the end (models/polish.py) and ``record_history`` a
per-check residual trace. :func:`prepare` factors once for repeated solves
(:class:`PreparedFactor`, ``solve(prepared=)``), and
:func:`solve_segmented` runs a long solve as bounded segments.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.problem import QP, pad_qp
from ..core.settings import (RHO_MAX, RHO_MIN, KKTBackendKind, Settings,
                             chunk_precision)
from ..core.lockstep import read_flags
from ..core.state import SolveInfo, Solution, SolverState, Status
from ..ops.linalg import (inf_norm, kernel_dtype_ok, mm, mv, products,
                          spd_inverse)
from ..utils.profiling import span
from . import anderson as anderson_mod
from . import kkt as kkt_mod
from .plan import check_require_fused, plan as plan_fn
from .polish import polish as polish_fn


def _as_tensor(v, qp: QP):
    return torch.as_tensor(v, dtype=qp.dtype, device=qp.device).contiguous()


def _init_state(qp: QP, settings: Settings, backend, x0=None, z0=None,
                y0=None, rho0=None, aa0=None, prepared=None) -> SolverState:
    batch = qp.batch_shape
    kw = dict(dtype=qp.dtype, device=qp.device)
    x = torch.zeros(batch + (qp.n,), **kw) if x0 is None else _as_tensor(x0, qp)
    z = torch.zeros(batch + (qp.m,), **kw) if z0 is None else _as_tensor(z0, qp)
    y = torch.zeros(batch + (qp.m,), **kw) if y0 is None else _as_tensor(y0, qp)
    with span("qps.factor"):
        if prepared is not None:
            # The factor is valid only at its own rho; the q-dependent part
            # of the cache is refreshed here (one batched product).
            rho = _as_tensor(prepared.rho, qp).expand(batch).clone()
            cache = prepared.materialize(qp)
        else:
            rho = (torch.full(batch, settings.rho, **kw) if rho0 is None
                   else _as_tensor(rho0, qp).expand(batch).clone())
            cache = backend.init(qp, rho, settings.sigma_for(qp.dtype),
                                 settings)
    history = None
    if settings.record_history:
        history = {k: torch.full((settings.num_checks,) + batch, float("inf"),
                                 **kw) for k in ("res_prim", "res_dual", "rho")}
    aa = None
    if settings.anderson_memory > 0:
        aa = aa0 if aa0 is not None else anderson_mod.init_aa(qp, settings)
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
        iteration=0, kkt_cache=cache, products=products, history=history,
        aa=aa)


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
                       chunk_prods=None, aa_accept=None) -> SolverState:
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
        Ax, ATy, Px = qp.matvec_A(x), qp.matvec_At(y), qp.matvec_P(x)
    elif len(chunk_prods) == 3:  # selected by the Anderson step
        Ax, ATy, Px = chunk_prods
    else:  # computed inside the fused chunk kernel
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
    if aa_accept is not None:
        # A lane that took an Anderson step compares x against the plain
        # chunk's penultimate iterate, a point of another map.
        admm_fp &= ~aa_accept

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
    history = state.history
    if history is not None:
        idx = state.iteration // settings.check_interval
        history["res_prim"][idx] = res_prim
        history["res_dual"][idx] = res_dual
        history["rho"][idx] = state.rho
    products = None
    if state.products is not None:
        products = {"Px": Px, "Ax": Ax, "ATy": ATy}
    return dataclasses.replace(
        state, x=x, z=z, y=y, rho_cand=rho_cand, status=status,
        iterations=iterations,
        res_prim=torch.where(active, res_prim, state.res_prim),
        res_dual=torch.where(active, res_dual, state.res_dual),
        iteration=iteration, products=products, history=history)


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
    with span("qps.factor"):
        rho = torch.where(tripped, state.rho_cand, state.rho)
        cache = backend.refactor(state.kkt_cache, qp, rho,
                                 settings.sigma_for(qp.dtype), settings)
    # A re-adopted rho changes the Anderson encoding w = z + y/rho and the
    # map itself: the lane's history restarts.
    aa = anderson_mod.reset_aa(state.aa, tripped)
    return dataclasses.replace(state, rho=rho, kkt_cache=cache, aa=aa)


def _solve_core(qp: QP, settings: Settings, x0, z0, y0, rho0,
                term_scale=None, aa0=None, prepared=None):
    """The check loop; returns (Solution, the Anderson carry or None)."""
    if settings.sigma_free_rhs and kkt_mod.resolve_backend(
            settings.kkt_backend, qp) is not KKTBackendKind.CHOLESKY:
        raise ValueError(
            "sigma_free_rhs is a dense CHOLESKY-backend optimization; "
            "other backends build the RHS per-solve anyway")
    backend = kkt_mod.get_backend(settings.kkt_backend, qp)
    state = _init_state(qp, settings, backend, x0, z0, y0, rho0, aa0,
                        prepared)
    max_iter = settings.num_checks * settings.check_interval
    while state.iteration < max_iter:
        tripped = _rho_trips(settings, state)
        flags = [(state.status == Status.RUNNING).any()]
        if tripped is not None:
            flags.append(tripped.any())
        flags = read_flags(torch.stack(flags))  # the check's one host sync
        _solve_core.syncs += 1
        if not flags[0]:
            break
        if tripped is not None:
            state = _maybe_refactor(qp, settings, backend, state, tripped,
                                    flags[1])
        with span("qps.chunk"):
            x, z, y, xp, zp, cache, prods = _run_chunk(qp, settings, backend,
                                                       state)
        aa_accept = None
        if settings.anderson_memory > 0:
            with span("qps.anderson"):
                x, z, y, prods, aa, aa_accept = anderson_mod.aa_step(
                    qp, settings, state, x, z, y, prods, term_scale)
            state = dataclasses.replace(state, aa=aa)
        state = dataclasses.replace(state, kkt_cache=cache)
        with span("qps.check"):
            state = _check_convergence(qp, settings, state, x, z, y, xp, zp,
                                       term_scale, prods, aa_accept)

    exhausted = state.status == Status.RUNNING
    status = state.status.masked_fill(exhausted, int(Status.MAX_ITERATIONS))
    iterations = state.iterations.masked_fill(exhausted, state.iteration)
    x, y = state.x, state.y
    if settings.polish_iterations > 0:
        with span("qps.polish"):
            x, y = polish_fn(qp, settings, x, state.z, y, state.rho)
        objective = qp.objective(x)
    elif state.products is not None:
        # Px was computed at the final check for this exact x.
        objective = 0.5 * (x * state.products["Px"]).sum(-1) + (qp.q * x).sum(-1)
    else:
        objective = qp.objective(x)
    info = SolveInfo(status=status, iterations=iterations,
                     res_prim=state.res_prim, res_dual=state.res_dual,
                     rho=state.rho, objective=objective,
                     history=state.history)
    return Solution(x=x, z=state.z, y=y, info=info), state.aa


_solve_core.syncs = 0


def _solve_impl(qp, settings: Settings, x0, z0, y0, rho0, scaling=None,
                aa0=None, return_aa=False, prepared=None):
    """The solve at the problem's own shape: pre-scaled (``scaling``),
    equilibrated here (``Settings.scaling_iters``) or plain. Returns the
    Solution, and the Anderson carry too with ``return_aa``."""
    from .scaling import equilibrate, scale_iterates, unscale_iterates

    def warm(v):
        return None if v is None else _as_tensor(v, qp)

    if scaling is not None:
        if settings.scaling_iters > 0:
            raise ValueError("pass either a pre-scaled problem (scaling=...) "
                             "or scaling_iters > 0, not both")
        scaling = scaling.to(qp.dtype, qp.device)
        xs, zs, ys = scale_iterates(scaling, warm(x0), warm(z0), warm(y0))
        sol, aa = _solve_core(qp, settings, xs, zs, ys, rho0,
                              term_scale=scaling, aa0=aa0)
        x, z, y = unscale_iterates(scaling, sol.x, sol.z, sol.y)
        # The in-loop residuals are already unscaled (term_scale); the
        # scaled problem's objective is c times the original's.
        info = dataclasses.replace(sol.info,
                                   objective=sol.info.objective / scaling.c)
        out = Solution(x=x, z=z, y=y, info=info)
    elif settings.scaling_iters > 0:
        if not qp.is_dense:
            raise ValueError("scaling_iters requires a dense QP")
        qp_s, scal = equilibrate(qp, settings.scaling_iters)
        xs, zs, ys = scale_iterates(scal, warm(x0), warm(z0), warm(y0))
        # The termination tests run on the unscaled residuals (term_scale),
        # so a lane is SOLVED only when the original problem's pass eps.
        sol, aa = _solve_core(qp_s, settings, xs, zs, ys, rho0,
                              term_scale=scal, aa0=aa0)
        x, z, y = unscale_iterates(scal, sol.x, sol.z, sol.y)
        # Residuals and objective again at the unscaled iterates (after the
        # unscale's rounding and any polish).
        res_prim = inf_norm(qp.matvec_A(x) - z)
        res_dual = inf_norm(qp.matvec_P(x) + qp.q + qp.matvec_At(y))
        info = dataclasses.replace(sol.info, res_prim=res_prim,
                                   res_dual=res_dual,
                                   objective=qp.objective(x))
        out = Solution(x=x, z=z, y=y, info=info)
    else:
        out, aa = _solve_core(qp, settings, x0, z0, y0, rho0, aa0=aa0,
                              prepared=prepared)
    return (out, aa) if return_aa else out


def _at_matmul_precision(fn):
    """fn(qp, settings, ...) inside ``products(settings.matmul_precision)``:
    the JAX package's ``jax.default_matmul_precision`` around its solve,
    prepare and Anderson-carrying solve (models/admm.py:185, 669, 843)."""
    @functools.wraps(fn)
    def scoped(qp, settings: Settings = Settings(), *args, **kwargs):
        with products(settings.matmul_precision):
            return fn(qp, settings, *args, **kwargs)

    return scoped


def _with_lanes(qp: QP) -> QP:
    """qp with every tensor carrying the fleet's batch axes, for the kernels
    that read one matrix a lane (a P or A shared by the fleet is stored
    once; this costs B copies of it, a ``qps.pad`` span)."""
    batch = qp.batch_shape
    if all(t.shape[: len(batch)] == batch and t.dim() == len(batch) + k
           for t, k in zip(qp.tensors(), (2, 1, 2, 1, 1))):
        return qp
    with span("qps.pad"):
        return QP(*(t.expand(batch + tuple(t.shape[-k:])).contiguous()
                    for t, k in zip(qp.tensors(), (2, 1, 2, 1, 1))))


@_at_matmul_precision
def solve(qp, settings: Settings = Settings(), x0=None, z0=None, y0=None,
          rho0=None, scaling=None, prepared=None) -> Solution:
    """Solve a (batched) box-constrained QP on the device its tensors are on.

    ``qp`` is a dense batched :class:`QP` or one large
    :class:`~..core.sparse_problem.SparseQP` (the matrix-free CG path).
    ``x0``/``z0``/``y0`` warm-start the iterates and ``rho0`` (scalar or
    per-lane) the penalty. ``scaling``: the ScalingData of a problem
    pre-scaled by Ruiz equilibration (``equilibrate_sparse_host`` then
    ``make_sparse_qp``); warm starts and the solution are in the original
    space and termination runs on unscaled residuals, as with
    ``settings.scaling_iters`` (which excludes ``scaling``). ``prepared``: a
    :class:`PreparedFactor` from :func:`prepare` for the same P and A (q, l
    and u may differ); the solve starts at its rho and skips the factor.
    A dense fleet that the fused chunk wants in 128-multiples is padded
    first (the inert padding of :func:`~..core.problem.pad_qp`; neither
    with ``scaling`` nor with ``prepared``), equilibrated after the pad
    when ``scaling_iters`` asks, solved, and sliced back. A P or A without
    the batch axes (shared by the fleet) is broadcast, and copied to one a
    lane only when a kernel of the plan reads it by lane. With
    ``settings.require_fused`` any requested kernel that would not run is
    an error (models/plan.py). Torch's products run at
    ``settings.matmul_precision`` inside (:func:`~..ops.linalg.products`),
    the factor's at ``factor_precision``; TF32 stays off.
    """
    with span("qps.solve"):
        if prepared is not None and (scaling is not None
                                     or settings.scaling_iters):
            raise ValueError("prepared factors cannot be combined with "
                             "scaling (equilibration rescales P/A, "
                             "invalidating them)")
        if qp.is_dense:  # contiguous: what the kernels take
            qp = QP(*(t.contiguous() for t in qp.tensors()))
        p = plan_fn(qp, settings, prepared=prepared is not None)
        if settings.require_fused:
            check_require_fused(p, "ADMM")
        if qp.is_dense and (p.chunk == "fused_kernel"
                            or p.factor == "fused_slab"):
            qp = _with_lanes(qp)
        if p.padded is not None and scaling is None and prepared is None:
            n_pad, m_pad = p.padded

            def vpad(v, w):
                if v is None:
                    return None
                v = _as_tensor(v, qp)
                return torch.nn.functional.pad(v, (0, w - v.shape[-1]))

            with span("qps.pad"):
                padded = pad_qp(qp, n_pad, m_pad)
                x0, z0, y0 = vpad(x0, n_pad), vpad(z0, m_pad), vpad(y0, m_pad)
            sol = _solve_impl(padded, settings, x0, z0, y0, rho0)
            return Solution(x=sol.x[..., : qp.n], z=sol.z[..., : qp.m],
                            y=sol.y[..., : qp.m], info=sol.info)
        return _solve_impl(qp, settings, x0, z0, y0, rho0, scaling,
                           prepared=prepared)


#: PyTorch runs eagerly; the alias keeps the JAX package's call sites.
solve_jit = solve


@dataclasses.dataclass(frozen=True)
class PreparedFactor:
    """A KKT factor prepared once for repeated :func:`solve` calls (the
    setup / update / solve contract of OSQP and of the reference's ProxQP).

    P, A, the batch shape and the rho structure (``rho_eq_scale``) must be
    those of the prepare-time problem; q, l and u are free. The solve adopts
    ``rho`` (the factor is valid only at its own rho); with ``adaptive_rho``
    a lane whose rho then drifts refactors in the loop as usual.

    ``M_inv`` is kept only on the sigma-free path, where the cached
    g = M^{-1}q depends on q: :meth:`materialize` refreshes it with one
    batched product a solve (G = M^{-1}A' does not depend on q).
    """

    cache: dict              # the backend's cache (its q-independent part)
    rho: torch.Tensor        # (*B,) penalty the factor was built at
    M_inv: torch.Tensor | None = None  # (*B, n, n), sigma_free_rhs only

    def materialize(self, qp: QP) -> dict:
        """The per-solve cache: the q-dependent pieces refreshed. G is
        passed on as it is, a contiguous (*B, n, m) tensor the sigma-free
        chunk kernel reads without a copy."""
        if self.M_inv is not None:
            return {"G": self.cache["G"], "g": mv(self.M_inv, qp.q)}
        return self.cache


@_at_matmul_precision
def prepare(qp: QP, settings: Settings = Settings(),
            rho0=None) -> PreparedFactor:
    """Factor the KKT system once for repeated :func:`solve` calls.

    For the dense CHOLESKY backend with ``sigma_free_rhs`` it keeps M^{-1}
    (``spd_inverse``: the pivot kernel's sweep at 128-multiple n on fleets
    of at least 4) and G = M^{-1}A', so each solve refreshes g for its own
    q; otherwise the backend's cache (M^{-1}, or CG's diagonal) is
    q-independent as it is. ``slab_cache``/``split_cache`` (single-solve
    layouts whose g lives in the slab) and ``scaling_iters`` (which rescales
    P and A a solve) raise. A prepared solve is not auto-padded: prepare a
    pre-padded problem (:func:`~..core.problem.pad_qp`) if the fused chunk
    is wanted.
    """
    if settings.slab_cache or settings.split_cache:
        raise ValueError(
            "prepare() does not support slab_cache/split_cache — those are "
            "single-solve memory layouts whose g lives inside the slab")
    if settings.scaling_iters > 0:
        raise ValueError(
            "prepare() with scaling_iters is unsupported: equilibration "
            "rescales P/A per solve, invalidating the factor; pre-scale "
            "the problem once instead")
    if qp.is_dense:
        qp = QP(*(t.contiguous() for t in qp.tensors()))
    backend = kkt_mod.get_backend(settings.kkt_backend, qp)
    batch = qp.batch_shape
    kw = dict(dtype=qp.dtype, device=qp.device)
    rho = (torch.full(batch, settings.rho, **kw) if rho0 is None
           else torch.as_tensor(rho0, **kw).expand(batch).clone())
    sigma = settings.sigma_for(qp.dtype)
    kind = kkt_mod.resolve_backend(settings.kkt_backend, qp)
    if kind is KKTBackendKind.CHOLESKY and settings.sigma_free_rhs:
        rho_row = kkt_mod.rho_rows(qp, rho, settings).expand(
            batch + (qp.m,)).contiguous()
        with products(settings.factor_precision or settings.matmul_precision):
            M_inv = spd_inverse(kkt_mod._build_normal_matrix(qp, rho_row, sigma))
            G = mm(M_inv, qp.A.transpose(-1, -2)).contiguous()
        return PreparedFactor(cache={"G": G}, rho=rho, M_inv=M_inv)
    return PreparedFactor(cache=backend.init(qp, rho, sigma, settings),
                          rho=rho)


#: PyTorch runs eagerly; the alias keeps the JAX package's call sites.
prepare_jit = prepare


@_at_matmul_precision
def _solve_carry_aa(qp: QP, settings: Settings, x0, z0, y0, rho0, scaling,
                    aa0):
    """:func:`solve` at the problem's own shape that threads the Anderson
    carry in and out: :func:`solve_segmented`'s worker, so the history is
    not restarted at every segment."""
    return _solve_impl(qp, settings, x0, z0, y0, rho0, scaling, aa0=aa0,
                       return_aa=True)


def _rho_candidate(qp: QP, x, z, y, rho):
    """The OSQP rho candidate at (x, z, y), kept at rho where undefined."""
    Ax, Px, ATy = qp.matvec_A(x), qp.matvec_P(x), qp.matvec_At(y)
    rp = inf_norm(Ax - z)
    rd = inf_norm(Px + qp.q + ATy)
    max_prim = torch.maximum(inf_norm(Ax), inf_norm(z))
    max_dual = torch.maximum(torch.maximum(inf_norm(Px), inf_norm(ATy)),
                             inf_norm(qp.q))
    den = rd * max_prim
    cand = torch.clamp(
        rho * torch.sqrt(rp * max_dual
                         / torch.where(den == 0, torch.ones_like(den), den)),
        RHO_MIN, RHO_MAX)
    ok = cand.isfinite() & (den != 0) & (cand > 0)
    return torch.where(ok, cand, rho)


@_at_matmul_precision
def solve_segmented(qp: QP, settings: Settings = Settings(),
                    segment_iterations: int = 100, x0=None, z0=None, y0=None,
                    host_rho_adaptation: bool = False,
                    scaling=None) -> Solution:
    """A long solve as bounded segments carrying (x, z, y, rho) between
    them: a segment boundary is just another check boundary, so the math
    is :func:`solve`'s (checkpointable solves; bounded work a call).

    ``host_rho_adaptation`` moves the adaptive-rho rule to the segment
    boundaries (segments run with ``adaptive_rho=False``). With
    ``anderson_memory`` the Anderson history is carried across segments
    (and restarts on lanes whose rho the host re-adopts). With
    ``record_history`` the segments' traces are stitched into one
    (num_checks, *B) trace, inf where no check ran. Lanes that finished in
    an earlier segment re-verify on re-entry, so their iteration counts are
    accurate to one check interval a further segment. ``scaling`` is
    forwarded to :func:`solve`.
    """
    seg_settings = settings
    if host_rho_adaptation:
        seg_settings = dataclasses.replace(settings, adaptive_rho=False)
    ci = settings.check_interval
    seg = -(-segment_iterations // ci) * ci
    total = settings.num_checks * ci
    done_iters = 0
    sol = None
    rho0 = None
    aa0 = None  # the Anderson carry, across segment boundaries
    histories = [] if settings.record_history else None
    while done_iters < total:
        # The last segment is clamped so the total stays within the budget.
        this_seg = min(seg, total - done_iters)
        seg_s = dataclasses.replace(seg_settings, max_iterations=this_seg)
        if settings.anderson_memory > 0:
            sol, aa0 = _solve_carry_aa(qp, seg_s, x0, z0, y0, rho0, scaling,
                                       aa0)
        else:
            sol = solve(qp, seg_s, x0, z0, y0, rho0, scaling)
        done_iters += this_seg
        if histories is not None:
            histories.append(sol.info.history)
        if bool((sol.info.status != Status.MAX_ITERATIONS).all()):
            break
        x0, z0, y0, rho0 = sol.x, sol.z, sol.y, sol.info.rho
        if host_rho_adaptation and settings.adaptive_rho:
            # The candidate in the space the iteration runs in (scaled when
            # the problem is pre-scaled), as in the loop.
            if scaling is not None:
                from .scaling import scale_iterates

                cx, cz, cy = scale_iterates(scaling.to(qp.dtype, qp.device),
                                            x0, z0, y0)
            else:
                cx, cz, cy = x0, z0, y0
            cand = _rho_candidate(qp, cx, cz, cy, sol.info.rho)
            rho = sol.info.rho
            f = settings.rho_factor
            trip = (cand * f < rho) | (cand > f * rho)
            rho0 = torch.where(trip, cand, rho)
            if aa0 is not None:
                # A host-adopted rho changes the encoding w = z + y/rho.
                aa0 = anderson_mod.reset_aa(aa0, trip)
    if histories is not None:
        from .proxqp import _concat_histories

        history = _concat_histories(histories, settings.num_checks)
    else:
        history = sol.info.history
    iterations = torch.clamp(sol.info.iterations + (done_iters - this_seg),
                             max=total).to(torch.int32)
    info = dataclasses.replace(sol.info, iterations=iterations,
                               history=history)
    return Solution(x=sol.x, z=sol.z, y=sol.y, info=info)
