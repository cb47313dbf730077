"""Batched ProxQP-style proximal-ALM solver (counterpart of the JAX package's
models/proxqp.py).

Solves fleets of equality/inequality-split QPs

    min 0.5 x'Px + q'x   s.t.   Ax = b,  Cx <= d

with slack s >= 0, one SPD matrix M = P + rho(A'A + C'C) + sigma*I refreshed
only on rho updates, and per iteration

    r = -q + sigma*x + A'(rho*b - y) + C'(rho*(d - s) - z)
    x = M^{-1} r
    s = max(d - Cx - z/rho, 0)
    y = y + rho*(Ax - b)
    z = max(z + rho*(Cx - d + s), 0)

(in sigma-free form, ProxQPSettings.sigma_free_rhs, x = Ga(rho b - y) +
Gc(rho(d - s) - z) - g with the column cache of M = P + rho(A'A + C'C)),
the PIQP convergence criteria 13a-c, the split-form Farkas certificates and
the tau-triggered double-square-root adaptive rho; optionally a guarded
Anderson step at each check (ProxQPSettings.anderson_memory,
models/anderson.py) and a per-check residual trace (record_history).

The JAX package's ``while_loop``/``scan`` becomes a host loop over check
intervals: each pass runs one chunk (one launch of a csrc/prox_chunk.cu
kernel on the fused path, sigma-free or M^{-1} form) and one convergence
check on the device. Where the loop needs to
know something (whether any lane still runs under ``early_exit``, whether any
lane's rho tripped), it reads both in ONE device-to-host sync at the top of
the next pass (agreed across the ranks of a distributed solve,
core/lockstep.py); ``lax.cond(any(trip))`` becomes a host ``if`` on that
flag. ``_solve_impl.syncs`` counts those reads and ``_solve_impl.solves`` the
solves; in a torch.profiler trace each layer is a span (utils/profiling.py),
as in models/admm.py.

The matrix-free path takes a :class:`~..core.sparse_problem.SparseProxQP`
(operator protocol; every product the ELL kernel, or CSR): the x-update is
Jacobi-preconditioned CG (models/kkt.py: ``_pcg``) on M = P + sigma*I +
rho(A'A + C'C), warm-started from the current x, so the "factor" is M's
diagonal, refreshed after every check's rho update (no sync), and the
default start is :func:`warm_start_operator`, the unconstrained minimizer.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.lockstep import read_flags
from ..core.problem import ProxQPProblem, pad_proxqp
from ..core.settings import ProxQPSettings, chunk_precision
from ..core.sparse_problem import SparseProxQP
from ..core.state import Status
from ..ops.fused_proxqp import (fused_proxqp_chunk, fused_proxqp_chunk_minv,
                                fused_proxqp_chunk_plain)
from ..ops.linalg import (add_scaled_identity, fp32_products, inf_norm,
                          kernel_dtype_ok, matvec, spd_inverse, spd_solve)
from ..utils.profiling import span
from . import anderson as anderson_mod
from .kkt import _pcg
from .plan import check_require_fused, plan_proxqp


@dataclasses.dataclass
class ProxQPInfo:
    """Per-lane diagnostics (batched)."""

    converged: torch.Tensor   # (*B,) bool
    iterations: torch.Tensor  # (*B,) int32
    res_prim: torch.Tensor    # (*B,)
    res_dual: torch.Tensor    # (*B,)
    rho: torch.Tensor         # (*B,)
    #: (*B,) int32 Status codes: MAX_ITERATIONS(1), SOLVED(3),
    #: PRIMAL_INFEASIBLE(4), DUAL_INFEASIBLE(5).
    status: torch.Tensor = None
    #: The residual trace {"res_prim", "res_dual", "rho"}, each of shape
    #: (num_checks, *B) and inf past the stopping check, when
    #: ProxQPSettings.record_history; else None.
    history: object = None


@dataclasses.dataclass
class ProxQPSolution:
    x: torch.Tensor           # (*B, n)
    s: torch.Tensor           # (*B, mi) slack of Cx <= d
    y: torch.Tensor           # (*B, me) equality duals
    z: torch.Tensor           # (*B, mi) inequality duals (>= 0)
    info: ProxQPInfo


def _require_problem(prob) -> None:
    if not isinstance(prob, (ProxQPProblem, SparseProxQP)):
        raise TypeError("the prox-ALM solver takes a ProxQPProblem or a "
                        f"SparseProxQP; got {type(prob).__name__}")


def _bcast(t: torch.Tensor, batch, *shape) -> torch.Tensor:
    """t broadcast to batch + shape and contiguous (no copy when it already
    has that shape and layout)."""
    return t.expand(tuple(batch) + shape).contiguous()


def warm_start(prob: ProxQPProblem, reg: float = 0.0):
    """Equality-only KKT warm start (dense only).

    Solves [[P, A'], [A, -reg*I]] [x; y] = [-q; b] and sets
    s = max(d - Cx, 0), z = 0.
    """
    n, me, mi = prob.n, prob.n_eq, prob.n_ineq
    batch = prob.batch_shape
    kw = dict(dtype=prob.dtype, device=prob.device)
    A = _bcast(prob.A, batch, me, n)
    top = torch.cat([_bcast(prob.P, batch, n, n), A.transpose(-1, -2)], dim=-1)
    reg_blk = (-reg * torch.eye(me, **kw)).expand(tuple(batch) + (me, me))
    K = torch.cat([top, torch.cat([A, reg_blk], dim=-1)], dim=-2)
    rhs = torch.cat([-prob.q, _bcast(prob.b, batch, me)], dim=-1)
    k = torch.linalg.solve(K, rhs.unsqueeze(-1)).squeeze(-1)
    x, y = k[..., :n], k[..., n:]
    s = torch.clamp_min(prob.d - prob.matvec_C(x), 0.0)
    z = torch.zeros(tuple(batch) + (mi,), **kw)
    return x, y, s, z


def warm_start_operator(prob, settings: ProxQPSettings):
    """Matrix-free warm start: x0 = (P + sigma*I)^{-1}(-q) by Jacobi-CG,
    y = z = 0, s = max(d - Cx0, 0).

    The equality-KKT solve of :func:`warm_start` is the factorization the
    matrix-free path exists to avoid; the unconstrained minimizer lands a
    lightly constrained problem (a smoothing with a few pinned samples)
    near a zero dual residual, and the ALM only has to enforce the
    constraints.
    """
    _require_problem(prob)
    sigma = settings.sigma
    dP = prob.diag_P() + sigma
    diag_inv = torch.where(dP > 0, 1.0 / dP, torch.ones_like(dP))
    x = _pcg(lambda v: prob.matvec_P(v) + sigma * v, -prob.q,
             torch.zeros_like(prob.q), diag_inv, abs_tol=settings.cg_eps,
             max_iterations=settings.cg_max_iterations)
    kw = dict(dtype=prob.dtype, device=prob.device)
    y = torch.zeros(prob.batch_shape + (prob.n_eq,), **kw)
    s = torch.clamp_min(prob.d - prob.matvec_C(x), 0.0)
    z = torch.zeros(prob.batch_shape + (prob.n_ineq,), **kw)
    return x, y, s, z


def _gram(prob: ProxQPProblem) -> torch.Tensor:
    """A'A + C'C."""
    return (torch.matmul(prob.A.transpose(-1, -2), prob.A)
            + torch.matmul(prob.C.transpose(-1, -2), prob.C))


def _build_M_inv(prob: ProxQPProblem, rho, sigma):
    M = prob.P + rho[..., None, None] * _gram(prob)
    return spd_inverse(add_scaled_identity(M, sigma))


def _fused_factor_ok(prob: ProxQPProblem) -> bool:
    n, me, mi = prob.n, prob.n_eq, prob.n_ineq
    return (kernel_dtype_ok(prob.dtype, prob.device)
            and len(prob.batch_shape) == 1
            and n % 128 == 0 and me % 128 == 0 and mi % 128 == 0
            and n > 0 and me > 0 and mi > 0)


def _build_sigma_free_cache(prob: ProxQPProblem, rho, settings) -> dict:
    """{G = M^{-1}[A' C'], g = M^{-1}q} with M = P + rho(A'A + C'C): the
    proximal sigma is dropped (exact ALM), so M must be invertible on its own
    (P with a PD part). G = [Ga | Gc] is one (*B, n, me + mi) tensor.

    With one batch axis and 128-multiple dims (f32, or f64 on the CPU) the
    factor runs through the slab kernels with A and C as two row blocks
    (ops/fused_factor.py); otherwise it is a multi-RHS ``spd_solve`` (the
    Gauss-Jordan sweep around the pivot kernel, or Cholesky off its shapes).
    """
    n, me, mi = prob.n, prob.n_eq, prob.n_ineq
    batch = prob.batch_shape
    m = me + mi
    if _fused_factor_ok(prob):
        from ..ops.fused_factor import fused_factor_solve

        S = fused_factor_solve(
            _bcast(prob.P, batch, n, n),
            (_bcast(prob.A, batch, me, n), _bcast(prob.C, batch, mi, n)),
            _bcast(prob.q, batch, n), _bcast(rho[..., None], batch, m),
            sigma=0.0)
        # Copies: the chunk kernel takes a contiguous (B, n, me + mi) G, and
        # the slab (n x (kp + n) per lane) is freed when this returns.
        return {"G": S[..., :m].contiguous(), "g": S[..., m].contiguous()}
    M = prob.P + rho[..., None, None] * _gram(prob)
    R = torch.cat([_bcast(prob.A, batch, me, n).transpose(-1, -2),
                   _bcast(prob.C, batch, mi, n).transpose(-1, -2),
                   _bcast(prob.q, batch, n)[..., None]], dim=-1)
    X = spd_solve(M, R)
    return {"G": X[..., :m].contiguous(), "g": X[..., m].contiguous()}


def _apply_M(prob, rho, sigma, v):
    """M @ v through the operator protocol."""
    return (prob.matvec_P(v) + sigma * v
            + rho[..., None] * (prob.matvec_At(prob.matvec_A(v))
                                + prob.matvec_Ct(prob.matvec_C(v))))


def _jacobi_inv(prob, rho, sigma):
    """1 / diag(M): the matrix-free path's whole "factorization"."""
    d = prob.diag_P() + sigma + rho[..., None] * (prob.diag_AtA()
                                                  + prob.diag_CtC())
    return torch.where(d > 0, 1.0 / d, torch.ones_like(d))


@dataclasses.dataclass
class PreparedProxFactor:
    """Prox-ALM factor prepared once for repeated solves (P, A, C fixed;
    q, b, d free). ``M_inv`` is carried only on the sigma-free path, to
    refresh the q-dependent g = M^{-1}q per solve."""

    cache: object             # {"G"} (sigma-free), M^{-1}, or M's diagonal
    rho: torch.Tensor
    M_inv: torch.Tensor | None = None

    def materialize(self, prob):
        if self.M_inv is not None:
            return {"G": self.cache["G"], "g": matvec(self.M_inv, prob.q)}
        return self.cache


@fp32_products()
def prepare(prob, settings: ProxQPSettings = ProxQPSettings(),
            rho0=None) -> PreparedProxFactor:
    """Factor M = P + rho(A'A + C'C) (+ sigma*I) once for repeated solves:
    M^{-1}, the sigma-free {G} with M^{-1} for g, or (a SparseProxQP) M's
    Jacobi diagonal.

    A prepared solve runs at the problem's own shape (no auto-pad): prepare
    on a pre-padded problem (:func:`~..core.problem.pad_proxqp`) if the
    fused chunk is wanted.
    """
    _require_problem(prob)
    batch = prob.batch_shape
    kw = dict(dtype=prob.dtype, device=prob.device)
    rho = (torch.full(batch, settings.rho, **kw) if rho0 is None
           else torch.as_tensor(rho0, **kw).expand(batch).clone())
    if settings.sigma_free_rhs:
        if not prob.is_dense:
            raise ValueError("sigma_free_rhs needs a dense ProxQP problem")
        M_inv = spd_inverse(prob.P + rho[..., None, None] * _gram(prob))
        G = torch.cat([torch.matmul(M_inv, prob.A.transpose(-1, -2)),
                       torch.matmul(M_inv, prob.C.transpose(-1, -2))], dim=-1)
        return PreparedProxFactor(cache={"G": G}, rho=rho, M_inv=M_inv)
    if prob.is_dense:
        return PreparedProxFactor(
            cache=_build_M_inv(prob, rho, settings.sigma), rho=rho)
    return PreparedProxFactor(cache=_jacobi_inv(prob, rho, settings.sigma),
                              rho=rho)


@fp32_products()
def solve(prob, settings: ProxQPSettings = ProxQPSettings(),
          init=None, rho0=None, prepared=None) -> ProxQPSolution:
    """Solve a (batched) dense split-form QP, or one matrix-free
    :class:`~..core.sparse_problem.SparseProxQP`, on the device its tensors
    are on.

    ``init`` optionally provides (x, y, s, z); by default the equality-KKT
    warm start is used (:func:`warm_start_operator` on a SparseProxQP).
    ``rho0`` (scalar or per-lane) warm-starts the penalty; ``prepared``
    (from :func:`prepare`) reuses a factor. A fleet that the fused chunk
    wants in 128-multiples is padded first
    (:func:`~..core.problem.pad_proxqp`), solved, and sliced back. With
    ``settings.require_fused`` any requested kernel that would not run is
    an error (models/plan.py). Torch's products run in full FP32 inside
    (:func:`~..ops.linalg.fp32_products`), here and in :func:`prepare`.
    """
    _require_problem(prob)
    with span("qps.solve"):
        if prob.is_dense:
            prob = ProxQPProblem(*(t.contiguous() for t in prob.tensors()))
        p = plan_proxqp(prob, settings, prepared=prepared is not None)
        if settings.require_fused:
            check_require_fused(p, "prox-ALM")
        return _solve_impl(prob, settings, init, rho0, prepared, p)


#: PyTorch runs eagerly; the alias keeps the JAX package's call sites.
solve_jit = solve


def _solve_impl(prob: ProxQPProblem, settings: ProxQPSettings, init, rho0,
                prepared, p) -> ProxQPSolution:
    _solve_impl.solves += 1
    sigma_free = settings.sigma_free_rhs
    if sigma_free and not prob.is_dense:
        raise ValueError("sigma_free_rhs needs a dense ProxQP problem")
    if sigma_free and settings.kkt_refinement_steps:
        raise ValueError("sigma_free_rhs excludes kkt_refinement_steps "
                         "(refinement needs the explicit M^{-1})")
    batch = prob.batch_shape
    kw = dict(dtype=prob.dtype, device=prob.device)
    sigma = settings.sigma

    if init is not None:
        x, y, s, z = (torch.as_tensor(v, **kw) for v in init)
    elif settings.kkt_warm_start and prob.is_dense:
        x, y, s, z = warm_start(prob)
    elif settings.kkt_warm_start:
        x, y, s, z = warm_start_operator(prob, settings)
    else:
        x = torch.zeros(batch + (prob.n,), **kw)
        y = torch.zeros(batch + (prob.n_eq,), **kw)
        s = torch.clamp_min(prob.d, 0.0)
        z = torch.zeros(batch + (prob.n_ineq,), **kw)

    # The kernels want 128-multiple (n, me, mi): pad (inert rows and
    # variables, see pad_proxqp) and slice the solution back below. The warm
    # start above ran on the unpadded problem: its equality-KKT solve would
    # be singular on all-zero padded rows.
    orig_dims = None
    if p.padded is not None:
        orig_dims = (prob.n, prob.n_eq, prob.n_ineq)
        with span("qps.pad"):
            prob = pad_proxqp(prob, *p.padded)
            F = torch.nn.functional
            x, y, s, z = (F.pad(v, (0, w - v.shape[-1])) for v, w in
                          zip((x, y, s, z), (p.padded[0], p.padded[1],
                                             p.padded[2], p.padded[2])))

    if prepared is not None:
        # The factor is valid only at its own rho.
        rho = torch.as_tensor(prepared.rho, **kw).expand(batch).clone()
    else:
        rho = (torch.full(batch, settings.rho, **kw) if rho0 is None
               else torch.as_tensor(rho0, **kw).expand(batch).clone())

    def refresh_factor(rho):
        with span("qps.factor"):
            if sigma_free:
                return _build_sigma_free_cache(prob, rho, settings)
            if prob.is_dense:
                return _build_M_inv(prob, rho, sigma)
            return _jacobi_inv(prob, rho, sigma)

    if prepared is not None:
        with span("qps.factor"):
            factor = prepared.materialize(prob)
    else:
        factor = refresh_factor(rho)

    fused = p.chunk == "fused_kernel"
    refine = settings.kkt_refinement_steps
    if fused:
        n, me, mi = prob.n, prob.n_eq, prob.n_ineq
        lanes = (settings.chunk_lanes
                 if batch[0] % settings.chunk_lanes == 0 else 1)
        A, C = _bcast(prob.A, batch, me, n), _bcast(prob.C, batch, mi, n)
        b, d = _bcast(prob.b, batch, me), _bcast(prob.d, batch, mi)
        if not sigma_free:
            q = _bcast(prob.q, batch, n)
            P = _bcast(prob.P, batch, n, n) if refine > 0 else None

    def ldiv(factor, rho, r, x0):
        if not prob.is_dense:
            # factor: M's inverse diagonal; x0 the warm start.
            return _pcg(lambda w: _apply_M(prob, rho, sigma, w), r, x0,
                        factor, abs_tol=settings.cg_eps,
                        max_iterations=settings.cg_max_iterations,
                        rel_tol=settings.cg_rel_eps)
        v = matvec(factor, r)
        for _ in range(refine):
            v = v + matvec(factor, r - _apply_M(prob, rho, sigma, v))
        return v

    def run_chunk(x, s, y, z, rho, factor, active, it):
        if fused and sigma_free:
            # The first-chunk schedule keys on this solve's own count, so
            # every segment of solve_segmented starts at the first precision.
            return fused_proxqp_chunk(
                factor["G"], A, C, factor["g"], b, d, x.contiguous(),
                s.contiguous(), y.contiguous(), z.contiguous(), rho, active,
                K=settings.check_interval, lanes=lanes,
                dot_precision=chunk_precision(settings, it))
        if fused:
            return fused_proxqp_chunk_minv(
                factor, A, C, P, q, b, d, x.contiguous(), s.contiguous(),
                y.contiguous(), z.contiguous(), rho, active,
                K=settings.check_interval, sigma=sigma, refine=refine,
                lanes=lanes)
        if sigma_free:
            return fused_proxqp_chunk_plain(
                factor["G"], prob.A, prob.C, factor["g"], prob.b, prob.d, x,
                s, y, z, rho, active, K=settings.check_interval)
        act = active[..., None]
        rho_col = rho[..., None]
        for _ in range(settings.check_interval):
            r = (-prob.q + sigma * x
                 + prob.matvec_At(rho_col * prob.b - y)
                 + prob.matvec_Ct(rho_col * (prob.d - s) - z))
            x_new = ldiv(factor, rho, r, x)
            Cx = prob.matvec_C(x_new)
            s_new = torch.clamp_min(prob.d - Cx - z / rho_col, 0.0)
            y_new = y + rho_col * (prob.matvec_A(x_new) - prob.b)
            z_new = torch.clamp_min(z + rho_col * (Cx - prob.d + s_new), 0.0)
            x = torch.where(act, x_new, x)
            s = torch.where(act, s_new, s)
            y = torch.where(act, y_new, y)
            z = torch.where(act, z_new, z)
        return x, s, y, z

    ci = settings.check_interval
    total = settings.num_checks * ci
    status = torch.zeros(batch, dtype=torch.int32, device=prob.device)
    iters_done = torch.full(batch, total, dtype=torch.int32, device=prob.device)
    res_p = torch.full(batch, float("inf"), **kw)
    res_d = torch.full(batch, float("inf"), **kw)
    prods_prev = None
    if settings.check_infeasibility:
        # Products at the start iterate: the base of the first check's
        # certificate deltas.
        prods_prev = {"Px": prob.matvec_P(x), "Aty": prob.matvec_At(y),
                      "Ctz": prob.matvec_Ct(z), "Ax": prob.matvec_A(x),
                      "Cx": prob.matvec_C(x)}
    norm_b, norm_d, norm_q = (
        inf_norm(v).expand(batch)
        for v in (prob.b, prob.d, prob.q))
    aa = None
    if settings.anderson_memory > 0:
        aa = anderson_mod.init_aa_proxqp(prob, settings)
    history = None
    if settings.record_history:
        history = {k: torch.full((settings.num_checks,) + batch, float("inf"),
                                 **kw) for k in ("res_prim", "res_dual", "rho")}
    it = 0
    trip = None
    for _ in range(settings.num_checks):
        if it > 0 and (settings.early_exit or trip is not None):
            flags = [(status == Status.RUNNING).any()]
            if trip is not None:
                flags.append(trip.any())
            flags = read_flags(torch.stack(flags))  # the pass's one host sync
            _solve_impl.syncs += 1
            if settings.early_exit and not flags[0]:
                break
            if trip is not None and flags[1]:
                factor = None  # free the old cache before building the new
                factor = refresh_factor(rho)

        with span("qps.chunk"):
            running = status == Status.RUNNING
            # early_exit freezes every finished lane; without it converged
            # lanes keep iterating (the reference's full budget) and only
            # infeasible ones freeze, since their iterates diverge by design.
            active = (running if settings.early_exit
                      else status < Status.PRIMAL_INFEASIBLE)
            x_in, s_in, y_in, z_in = x, s, y, z
            x, s, y, z = run_chunk(x, s, y, z, rho, factor, active, it)
        it += ci

        if aa is not None:
            with span("qps.anderson"):
                x, s, y, z, pr, aa, _ = anderson_mod.aa_step_proxqp(
                    prob, settings, aa, rho, active, x_in, s_in, y_in, z_in,
                    x, s, y, z)
            Px, Aty, Ctz, Ax, Cx = (pr[k] for k in ("Px", "Aty", "Ctz",
                                                      "Ax", "Cx"))
        with span("qps.check"):
            # PIQP criteria 13a-c.
            if aa is None:
                Px, Aty = prob.matvec_P(x), prob.matvec_At(y)
                Ctz, Ax = prob.matvec_Ct(z), prob.matvec_A(x)
                Cx = prob.matvec_C(x)
            res_prim = torch.maximum(inf_norm(Ax - prob.b),
                                     inf_norm(Cx - prob.d + s))
            res_dual = inf_norm(Px + Aty + Ctz + prob.q)
            max_prim = torch.stack([inf_norm(Ax), norm_b, inf_norm(Cx),
                                    norm_d, inf_norm(s)]).amax(0)
            max_dual = torch.stack([inf_norm(Px), inf_norm(Aty),
                                    inf_norm(Ctz), norm_q]).amax(0)
            eps_prim_t = settings.eps_abs + settings.eps_rel * max_prim
            eps_dual_t = settings.eps_abs + settings.eps_rel * max_dual
            now_conv = (res_prim < eps_prim_t) & (res_dual < eps_dual_t)
            status = status.masked_fill(running & now_conv,
                                        int(Status.SOLVED))
            if settings.check_infeasibility:
                status = _certificates(
                    prob, settings, status, running, x, y, z, x_in, y_in,
                    z_in, Px, Aty, Ctz, Ax, Cx, prods_prev, res_prim,
                    res_dual, eps_prim_t, eps_dual_t)
                prods_prev = {"Px": Px, "Aty": Aty, "Ctz": Ctz, "Ax": Ax,
                              "Cx": Cx}
            newly = running & (status != Status.RUNNING)
            iters_done = iters_done.masked_fill(newly, it)
            res_p = torch.where(active, res_prim, res_p)
            res_d = torch.where(active, res_dual, res_d)
            if history is not None:
                # The rho the chunk ran with (before this check adapts it).
                idx = it // ci - 1
                history["res_prim"][idx] = res_prim
                history["res_dual"][idx] = res_dual
                history["rho"][idx] = rho

            if settings.adaptive_rho:
                num = res_prim * max_dual
                den = res_dual * max_prim
                ratio = num / torch.where(den == 0, torch.ones_like(den),
                                          den)
                inv = 1.0 / torch.where(ratio == 0, torch.ones_like(ratio),
                                        ratio)
                trip = (active & ratio.isfinite() & (den != 0)
                        & ((ratio > settings.tau) | (inv > settings.tau)))
                # Double square root for smoother updates.
                rho_new = torch.clamp(
                    rho * torch.sqrt(torch.sqrt(
                        torch.where(trip, ratio, torch.ones_like(ratio)))),
                    settings.rho_min, settings.rho_max)
                rho = torch.where(trip, rho_new, rho)
                # rho changes the Anderson encoding u = s - z/rho and the
                # map.
                aa = anderson_mod.reset_aa(aa, trip)
                if not prob.is_dense:
                    # The O(n) diagonal is refreshed every check, with no
                    # sync (a lane whose rho did not trip keeps its
                    # diagonal).
                    factor = refresh_factor(rho)
                    trip = None

    status = status.masked_fill(status == Status.RUNNING,
                                int(Status.MAX_ITERATIONS))
    if orig_dims is not None:
        n0, me0, mi0 = orig_dims
        x, y, s, z = x[..., :n0], y[..., :me0], s[..., :mi0], z[..., :mi0]
    info = ProxQPInfo(converged=status == Status.SOLVED, iterations=iters_done,
                      res_prim=res_p, res_dual=res_d, rho=rho, status=status,
                      history=history)
    return ProxQPSolution(x=x, s=s, y=y, z=z, info=info)


_solve_impl.syncs = 0
_solve_impl.solves = 0


def _certificates(prob, settings, status, running, x, y, z, x_in, y_in, z_in,
                  Px, Aty, Ctz, Ax, Cx, prev, res_prim, res_dual, eps_prim_t,
                  eps_dual_t):
    """Split-form Farkas certificates from the chunk's iterate differences:
    primal-infeasible when (dy, dz) has A'dy + C'dz ~ 0, b'dy + d'dz < 0 and
    dz >= 0; dual-infeasible when dx has P dx ~ 0, A dx ~ 0, C dx <~ 0 and
    q'dx < 0. The products of the chunk's start point were kept from the
    previous check, so the deltas cost no extra products."""
    eps_pi, eps_di = settings.eps_prim_inf, settings.eps_dual_inf
    dy, dz, dx = y - y_in, z - z_in, x - x_in
    ndyz = torch.maximum(inf_norm(dy), inf_norm(dz))
    stat = inf_norm((Aty - prev["Aty"]) + (Ctz - prev["Ctz"]))
    gap = (prob.b * dy).sum(-1) + (prob.d * dz).sum(-1)
    sign_ok = (dz >= -(eps_pi * ndyz)[..., None]).all(-1)
    prim_inf = ((ndyz > 0) & (stat <= eps_pi * ndyz)
                & (gap <= -eps_pi * ndyz) & sign_ok)
    ndx = inf_norm(dx)
    dual_inf = ((ndx > 0)
                & (inf_norm(Px - prev["Px"]) <= eps_di * ndx)
                & (inf_norm(Ax - prev["Ax"]) <= eps_di * ndx)
                & (Cx - prev["Cx"] <= (eps_di * ndx)[..., None]).all(-1)
                & ((prob.q * dx).sum(-1) <= -eps_di * ndx))
    # Anti-false-positive gates: far from convergence, and deltas above the
    # iterate noise floor.
    noise = 16 * torch.finfo(x.dtype).eps
    yz_scale = torch.clamp(torch.maximum(inf_norm(y), inf_norm(z)), min=1.0)
    prim_inf &= (res_prim > 10 * eps_prim_t) & (ndyz > noise * yz_scale)
    dual_inf &= (res_dual > 10 * eps_dual_t) & (
        ndx > noise * torch.clamp(inf_norm(x), min=1.0))
    overridable = running & (status == Status.RUNNING)
    status = status.masked_fill(overridable & prim_inf,
                                int(Status.PRIMAL_INFEASIBLE))
    return status.masked_fill(overridable & dual_inf & ~prim_inf,
                              int(Status.DUAL_INFEASIBLE))


@fp32_products()
def solve_segmented(prob, settings: ProxQPSettings = ProxQPSettings(),
                    segment_iterations: int = 250,
                    init=None) -> ProxQPSolution:
    """Host-driven segmented solve: bounded solves with the (x, y, s, z, rho)
    carry between them. A segment boundary is just another check boundary,
    so the math is unchanged; lanes that finished in an earlier segment
    re-verify on re-entry (iteration counts accurate to one check interval
    per extra segment). ``init`` forwards to the first segment only. The
    Anderson history restarts at each segment (unlike the ADMM family's);
    ``record_history`` traces are stitched into one (num_checks, *B)."""
    seg = -(-segment_iterations // settings.check_interval) * settings.check_interval
    total = settings.num_checks * settings.check_interval
    done_iters = 0
    sol = None
    rho0 = None
    histories = [] if settings.record_history else None
    while done_iters < total:
        this_seg = min(seg, total - done_iters)
        seg_s = dataclasses.replace(settings, max_iterations=this_seg)
        sol = solve(prob, seg_s, init, rho0)
        done_iters += this_seg
        if histories is not None:
            histories.append(sol.info.history)
        if bool((sol.info.status != Status.MAX_ITERATIONS).all()):
            break
        init = (sol.x, sol.y, sol.s, sol.z)
        rho0 = sol.info.rho
    iterations = torch.clamp(sol.info.iterations + (done_iters - this_seg),
                             max=total).to(torch.int32)
    info = dataclasses.replace(
        sol.info, iterations=iterations,
        history=_concat_histories(histories, settings.num_checks))
    return ProxQPSolution(x=sol.x, s=sol.s, y=sol.y, z=sol.z, info=info)


def _concat_histories(histories, num_checks: int):
    """Stitch per-segment traces into one (num_checks, *B) trace: segments
    cover disjoint check windows, so concatenation along the check axis is
    the whole trace, and checks never run (an early all-lane exit) stay inf.
    Shared by both families' segmented solves."""
    if not histories:
        return None
    out = {k: torch.cat([h[k] for h in histories], dim=0)
           for k in histories[0]}
    got = out["res_prim"].shape[0]
    if got < num_checks:
        out = {k: torch.nn.functional.pad(
                   v, (0,) * (2 * (v.dim() - 1)) + (0, num_checks - got),
                   value=float("inf"))
               for k, v in out.items()}
    return out
