"""KKT backends (counterpart of the JAX package's models/kkt.py): the dense
CHOLESKY and KKT_LDL backends and the iterative CG and KKT_MINRES backends,
behind one registry.

Every iteration solves the reduced KKT system with M = P + sigma*I +
A' diag(rho) A (SPD):

    xx = M^{-1} (sigma*x - q + A'(rho*z - y)),      zz = A xx.

CHOLESKY caches M^{-1}, or, in sigma-free form (Settings.sigma_free_rhs),
G = M^{-1}A' and g = M^{-1}q with xx = G(rho*z - y) - g: a copy {G, g}, the
factor's slab {S, g} (Settings.slab_cache) or G's bf16 halves {Ghi, Glo, g}
(Settings.split_cache). Off the fused slab factor, M^{-1} and {G, g} come
from ``spd_inverse``/``spd_solve`` (ops/linalg.py: the blocked Gauss-Jordan
sweep around the pivot kernel on its shapes, Cholesky elsewhere).

CG never forms M: Jacobi-preconditioned conjugate gradients on the operator
v -> Pv + sigma v + A'(rho (Av)), warm-started from the previous iteration's
xx (the cache carries it), the large sparse path's backend. AUTO resolves to
CHOLESKY for dense problems with n + m <= MAX_DIRECT_KKT_DIM and to CG
otherwise.

KKT_LDL and KKT_MINRES solve the quasi-definite 2x2 KKT system
K = [[P + sigma*I, A'], [A, -diag(1/rho)]] instead: LDL' factors K once a
rho (a loop over its columns, two triangular solves a solve); MINRES
iterates on K with the block-diagonal preconditioner
[(P + sigma*I)^{-1}, diag(rho)] (the Jacobi diagonal of P + sigma*I on a
sparse problem), which does not depend on rho, so its refactor is free.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.lockstep import read_flags
from ..core.problem import QP
from ..core.settings import MAX_DIRECT_KKT_DIM, KKTBackendKind, Settings
from ..ops.linalg import (add_scaled_identity, bf16_split, kernel_dtype_ok,
                          mm, mv, products, spd_inverse, spd_solve, sym)


def resolve_backend(kind: KKTBackendKind, qp) -> KKTBackendKind:
    """The JAX package's static selection: sparse problems always take the
    matrix-free CG path; dense problems go direct (CHOLESKY) below the size
    threshold. CHOLESKY and KKT_LDL on a sparse problem raise ValueError."""
    if kind is not KKTBackendKind.AUTO:
        if (kind in (KKTBackendKind.CHOLESKY, KKTBackendKind.KKT_LDL)
                and not qp.is_dense):
            raise ValueError(f"{kind} requires a dense QP; use CG for SparseQP")
        return kind
    if qp.is_dense and qp.n + qp.m <= MAX_DIRECT_KKT_DIM:
        return KKTBackendKind.CHOLESKY
    return KKTBackendKind.CG


def row_weights(qp, settings: Settings):
    """Per-constraint penalty weights w (rho_i = rho * w_i): equality rows
    get settings.rho_eq_scale; None when that is 1."""
    if settings.rho_eq_scale == 1.0:
        return None
    tol = 1e-9 * torch.clamp(qp.u.abs(), min=1.0)
    is_eq = qp.l.isfinite() & qp.u.isfinite() & ((qp.u - qp.l).abs() <= tol)
    one = torch.ones((), dtype=qp.dtype, device=qp.device)
    return torch.where(is_eq, one * settings.rho_eq_scale, one)


def rho_rows(qp, rho, settings: Settings):
    """(rho * w) as a (*B, m)-broadcastable tensor."""
    w = row_weights(qp, settings)
    r = rho[..., None]
    return r if w is None else r * w


def _full_rho_row(qp, rho, settings: Settings) -> torch.Tensor:
    return rho_rows(qp, rho, settings).expand(
        qp.batch_shape + (qp.m,)).contiguous()


def _build_normal_matrix(qp: QP, rho_row, sigma):
    """P + sigma*I + A' diag(rho_row) A, the gram at the scope's precision."""
    AtWA = mm(qp.A.transpose(-1, -2) * rho_row[..., None, :], qp.A)
    return add_scaled_identity(qp.P + AtWA, sigma)


def _fused_factor_ok(qp: QP, settings: Settings) -> bool:
    return (
        settings.fused_factor
        and settings.sigma_free_rhs
        and qp.is_dense
        and kernel_dtype_ok(qp.dtype, qp.device)
        and len(qp.batch_shape) == 1
        and qp.n % 128 == 0 and qp.n > 0
        and qp.m % 128 == 0 and qp.m > 0
    )


def cholesky_init(qp: QP, rho, sigma, settings: Settings) -> dict:
    rho_row = _full_rho_row(qp, rho, settings)
    if _fused_factor_ok(qp, settings):
        from ..ops.fused_factor import fused_factor_solve

        # Settings.pivot_variant picks the pivot sweep; factor_precision
        # "high" the bf16x3 level products ("default" runs the FP32 level,
        # as in the JAX package). The build and the pivots stay FP32.
        S = fused_factor_solve(
            qp.P, qp.A, qp.q, rho_row, sigma=float(settings.sigma_for(qp.dtype)),
            pivot_variant=settings.pivot_variant,
            dot_precision=("high" if settings.factor_precision == "high"
                           else "highest"))
        g = S[..., qp.m].contiguous()
        if settings.split_cache and qp.dtype == torch.float32:
            # Settings.split_cache: G's two bf16 halves, split once here
            # exactly as the kernel splits in registers (ops/linalg.py:
            # bf16_split); the slab is freed when this returns. (Eager torch
            # keeps the bf16 round trip that the JAX package has to pin with
            # an optimization barrier.) In float64 the halves would round
            # the solve: there the cache stays G, as in JAX's f64 solve.
            Ghi, Glo = bf16_split(S[..., : qp.m])
            return {"Ghi": Ghi, "Glo": Glo, "g": g}
        if settings.slab_cache:
            # Settings.slab_cache: the chunk reads G as a window of the slab
            # (its first m columns), so no (B, n, m) copy is made; the slab
            # stays live through the solve.
            return {"S": S, "g": g}
        # Copies: the chunk kernel takes a contiguous (B, n, m) G, and the
        # slab (n x (kp + n) per lane) is freed when this returns.
        return {"G": S[..., : qp.m].contiguous(), "g": g}
    # Off the slab the factor's products run at factor_precision (default:
    # matmul_precision), as the JAX package's do (models/kkt.py:182): M's
    # build and the sweep's products around the FP32 pivot kernel. A
    # reduced M^{-1} is a preconditioner; the refinement's residual runs at
    # the solve's precision.
    with products(settings.factor_precision or settings.matmul_precision):
        M = _build_normal_matrix(qp, rho_row, sigma)
        if settings.sigma_free_rhs:
            At = qp.A.transpose(-1, -2).expand(qp.batch_shape + (qp.n, qp.m))
            R = torch.cat([At, qp.q[..., :, None]], dim=-1)
            X = spd_solve(M, R)
            return {"G": X[..., : qp.m].contiguous(),
                    "g": X[..., qp.m].contiguous()}
        return {"M_inv": spd_inverse(M)}


def cholesky_refactor(cache, qp: QP, rho, sigma, settings: Settings) -> dict:
    return cholesky_init(qp, rho, sigma, settings)


def _normal_rhs(qp, x, z, y, rho_row, sigma):
    """sigma*x - q + A'(rho_row*z - y): the reduced-KKT right-hand side."""
    return sigma * x - qp.q + qp.matvec_At(rho_row * z - y)


def _apply_normal(qp, rho_row, sigma, v):
    """Matrix-free M @ v = P v + sigma v + A'(rho_row * (A v))."""
    return qp.matvec_P(v) + sigma * v + qp.matvec_At(rho_row * qp.matvec_A(v))


def cholesky_solve(cache, qp: QP, x, z, y, rho, settings: Settings):
    sigma = settings.sigma_for(qp.dtype)
    rho_row = rho_rows(qp, rho, settings)
    if settings.sigma_free_rhs:
        # The slab and split caches exist only where the fused chunk runs
        # (Settings requires fused_chunk for them, and the fused factor's
        # gate implies the chunk's), so this path always holds a copy of G.
        xx = mv(cache["G"], rho_row * z - y) - cache["g"]
        return xx, qp.matvec_A(xx), cache
    b = _normal_rhs(qp, x, z, y, rho_row, sigma)
    M_inv = cache["M_inv"]
    xx = mv(M_inv, b)
    for _ in range(settings.kkt_refinement_steps):
        xx = xx + mv(M_inv, b - _apply_normal(qp, rho_row, sigma, xx))
    return xx, qp.matvec_A(xx), cache


# --------------------------------------------------------------------------
# Quasi-definite KKT LDL' backend
# --------------------------------------------------------------------------
#
# Factors K = [[P + sigma*I, A'], [A, -diag(1/rho)]] as L D L' with unit-lower
# L and signed diagonal D, without pivoting (a quasi-definite matrix needs
# none). Refactoring happens only when a lane's rho trips; each solve is two
# batched triangular solves.


def _build_kkt_matrix(qp: QP, rho_row, sigma):
    """K (*B, n + m, n + m) with rho_row a full (*B, m) tensor."""
    n, m = qp.n, qp.m
    batch = qp.batch_shape
    A = qp.A.expand(batch + (m, n))
    Pn = add_scaled_identity(sym(qp.P), sigma).expand(batch + (n, n))
    neg = (-1.0 / rho_row)[..., None] * torch.eye(m, dtype=qp.dtype,
                                                  device=qp.device)
    top = torch.cat([Pn, A.transpose(-1, -2)], dim=-1)
    return torch.cat([top, torch.cat([A, neg], dim=-1)], dim=-2)


def _ldl_factor(K):
    """Batched dense LDL' without pivoting: K (*B, N, N) -> (L unit-lower,
    d (*B, N)).

    The JAX package scans the columns with a masked rank-1 update of the
    whole matrix, which changes no element outside the trailing block (it
    subtracts 0 there); this loop updates only W[j+1:, j+1:], with the same
    arithmetic, so the bits are the same at about a third of the traffic.
    """
    N = K.shape[-1]
    W = K.clone()
    L = torch.zeros_like(K)
    d = torch.empty(K.shape[:-1], dtype=K.dtype, device=K.device)
    for j in range(N):
        dj = W[..., j, j]
        c = W[..., j + 1:, j]  # column j below the diagonal
        lcol = c / dj[..., None]
        L[..., j + 1:, j] = lcol
        d[..., j] = dj
        W[..., j + 1:, j + 1:] -= lcol[..., :, None] * c[..., None, :]
    L.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    return L, d


def _ldl_apply_kkt(qp: QP, rho_row, sigma, v):
    """K @ v, matrix-free (the refinement residual, and MINRES's operator)."""
    n = qp.n
    v1, v2 = v[..., :n], v[..., n:]
    top = qp.matvec_P(v1) + sigma * v1 + qp.matvec_At(v2)
    bot = qp.matvec_A(v1) - v2 / rho_row
    return torch.cat([top, bot], dim=-1)


def kkt_ldl_init(qp: QP, rho, sigma, settings: Settings) -> dict:
    L, d = _ldl_factor(_build_kkt_matrix(
        qp, _full_rho_row(qp, rho, settings), sigma))
    return {"L": L, "d": d}


def kkt_ldl_refactor(cache, qp: QP, rho, sigma, settings: Settings) -> dict:
    return kkt_ldl_init(qp, rho, sigma, settings)


def _ldl_solve_vec(cache, b):
    """K^{-1} b from the factor: L w = b, w /= d, L' v = w."""
    L, d = cache["L"], cache["d"]
    w = torch.linalg.solve_triangular(L, b[..., None], upper=False,
                                      unitriangular=True)[..., 0] / d
    return torch.linalg.solve_triangular(
        L.transpose(-1, -2), w[..., None], upper=True,
        unitriangular=True)[..., 0]


def kkt_ldl_solve(cache, qp: QP, x, z, y, rho, settings: Settings):
    """Solve the whole KKT system, then zz = z + (v2 - y)/rho (per-row rho)."""
    sigma = settings.sigma_for(qp.dtype)
    rho_row = rho_rows(qp, rho, settings)
    rhs = torch.cat([sigma * x - qp.q, z - y / rho_row], dim=-1)
    v = _ldl_solve_vec(cache, rhs)
    for _ in range(settings.kkt_refinement_steps):
        v = v + _ldl_solve_vec(cache, rhs - _ldl_apply_kkt(qp, rho_row, sigma, v))
    xx = v[..., : qp.n]
    zz = z + (v[..., qp.n:] - y) / rho_row
    return xx, zz, cache


# --------------------------------------------------------------------------
# Quasi-definite MINRES backend (iterative path on the 2x2 KKT)
# --------------------------------------------------------------------------
#
# CG iterates on the normal matrix, whose condition number is the square of
# the KKT system's; MINRES iterates on the symmetric indefinite KKT system
# itself, preconditioned by the SPD block diagonal [(P + sigma*I)^{-1},
# diag(rho)]. The dense preconditioner caches (P + sigma*I)^{-1} once (it
# does not depend on rho, so a rho refactor is free); a sparse problem uses
# the Jacobi diagonal of P + sigma*I instead.


def kkt_minres_init(qp, rho, sigma, settings: Settings) -> dict:
    cache = {"v": torch.zeros(qp.batch_shape + (qp.n + qp.m,),
                              dtype=qp.dtype, device=qp.device)}
    if qp.is_dense:
        # spd_inverse: the Gauss-Jordan sweep around the pivot kernel on a
        # fleet of >= 4 lanes at 128-multiple n. A P shared by the fleet
        # gives one (n, n) inverse that every lane's product reads (no
        # per-lane copy).
        cache["P_inv"] = spd_inverse(add_scaled_identity(sym(qp.P), sigma))
    else:
        cache["d1_inv"] = 1.0 / (qp.diag_P() + sigma)
    return cache


def kkt_minres_refactor(cache, qp, rho, sigma, settings: Settings) -> dict:
    # The preconditioner depends only on P and sigma: rho drift is free.
    return cache


def _kkt_precond(cache, qp, rho_row):
    """The SPD block-diagonal preconditioner's inverse, as a function."""
    n = qp.n

    def apply(v):
        v1, v2 = v[..., :n], v[..., n:]
        if "P_inv" not in cache:
            u1 = cache["d1_inv"] * v1
        elif cache["P_inv"].dim() == 2:
            u1 = mm(v1, cache["P_inv"].transpose(-1, -2))
        else:
            u1 = mv(cache["P_inv"], v1)
        return torch.cat([u1, rho_row * v2], dim=-1)

    return apply


def kkt_minres_solve(cache, qp, x, z, y, rho, settings: Settings):
    sigma = settings.sigma_for(qp.dtype)
    rho_row = rho_rows(qp, rho, settings)
    rhs = torch.cat([sigma * x - qp.q, z - y / rho_row], dim=-1)
    v = _minres(lambda w: _ldl_apply_kkt(qp, rho_row, sigma, w),
                _kkt_precond(cache, qp, rho_row), rhs, cache["v"],
                abs_tol=settings.cg_eps,
                max_iterations=settings.cg_max_iterations)
    xx = v[..., : qp.n]
    zz = z + (v[..., qp.n:] - y) / rho_row
    return xx, zz, {**cache, "v": v}


def _minres(apply_K, precond, b, x0, abs_tol: float, max_iterations: int,
            vdot=None, rel_tol: float = 0.0):
    """Batched preconditioned MINRES (Paige and Saunders) with per-lane
    masking (the JAX package's ``_minres``, models/kkt.py:393-470).

    Solves K v = b for a symmetric (indefinite) K with an SPD preconditioner
    ``precond`` (M^{-1} applied); ``phibar``, the M^{-1}-norm of the
    residual, stops a lane at max(abs_tol, max(rel_tol, 10 ulp) ||b||), and
    a Lanczos breakdown (beta <= ulp * beta1: the solution is exact) stops
    it too. Every division is guarded, so a stopped lane stays finite.
    ``vdot(a, b) -> (*batch,)`` overrides the inner product.

    JAX's ``lax.while_loop`` becomes a host loop whose condition reads
    "every lane done" back from the device once a step (``_minres.syncs``
    counts these reads, ``_minres.steps`` the steps; inside a distributed
    solve the ranks agree on it, core/lockstep.py). A done lane keeps its
    x bit for bit.
    """
    if vdot is None:
        def vdot(a, c):
            return (a * c).sum(-1)
    eps = torch.finfo(b.dtype).eps
    b_norm = torch.sqrt(torch.clamp(vdot(b, b), min=0.0))
    tol = torch.clamp(max(rel_tol, 10 * eps) * b_norm, min=abs_tol)

    def guard(t):
        return torch.where(t == 0, torch.ones_like(t), t)

    x = x0
    r1 = b - apply_K(x0)
    y = precond(r1)
    beta1 = torch.sqrt(torch.clamp(vdot(r1, y), min=0.0))
    breakdown = eps * beta1
    r2 = r1
    zero = torch.zeros_like(beta1)
    beta, dbar, epsln, phibar = beta1, zero, zero, beta1
    cs, sn = -torch.ones_like(beta1), zero
    beta_g = oldb_g = guard(beta1)  # beta and the last step's, guarded
    w = w2 = torch.zeros_like(b)
    done = beta1 <= tol
    it = 0
    while it < max_iterations:
        _minres.syncs += 1
        if not read_flags((~done).any().reshape(1))[0]:
            break
        v = y / beta_g[..., None]
        yn = apply_K(v)
        if it >= 1:  # JAX subtracts 0 * r1 at the first step
            yn = yn - (beta / oldb_g)[..., None] * r1
        alfa = vdot(v, yn)
        yn = yn - (alfa / beta_g)[..., None] * r2
        r1, r2 = r2, yn
        y = precond(r2)
        beta, oldb_g = torch.sqrt(torch.clamp(vdot(r2, y), min=0.0)), beta_g
        beta_g = guard(beta)
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.clamp(torch.sqrt(gbar * gbar + beta * beta), min=eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1, w2 = w2, w
        w = (v - oldeps[..., None] * w1 - delta[..., None] * w2) / gamma[..., None]
        x = torch.where(done[..., None], x, torch.addcmul(x, phi[..., None], w))
        done = done | (phibar <= tol) | (beta <= breakdown)
        it += 1
    _minres.steps += it
    return x


_minres.steps = 0
_minres.syncs = 0


# --------------------------------------------------------------------------
# Matrix-free PCG backend (iterative path)
# --------------------------------------------------------------------------

def _jacobi_diag_inv(qp, rho, sigma, settings: Settings):
    w = row_weights(qp, settings)
    if w is None:
        d = qp.diag_P() + sigma + rho[..., None] * qp.diag_AtA()
    else:
        d = qp.diag_P() + sigma + rho[..., None] * qp.diag_AtWA(w)
    return torch.where(d > 0, 1.0 / d, torch.ones_like(d))


def cg_init(qp, rho, sigma, settings: Settings) -> dict:
    return {
        "diag_inv": _jacobi_diag_inv(qp, rho, sigma, settings),
        # Warm start from the previous iteration's solution: the solve
        # returns its xx in the cache, which the ADMM loop carries.
        "xx": torch.zeros(qp.batch_shape + (qp.n,), dtype=qp.dtype,
                          device=qp.device),
    }


def cg_refactor(cache, qp, rho, sigma, settings: Settings) -> dict:
    return {"diag_inv": _jacobi_diag_inv(qp, rho, sigma, settings),
            "xx": cache["xx"]}


def cg_solve(cache, qp, x, z, y, rho, settings: Settings):
    sigma = settings.sigma_for(qp.dtype)
    rho_row = rho_rows(qp, rho, settings)
    b = _normal_rhs(qp, x, z, y, rho_row, sigma)
    xx = _pcg(lambda v: _apply_normal(qp, rho_row, sigma, v), b, cache["xx"],
              cache["diag_inv"], abs_tol=settings.cg_eps,
              max_iterations=settings.cg_max_iterations,
              rel_tol=settings.cg_rel_eps)
    return xx, qp.matvec_A(xx), {**cache, "xx": xx}


def _pcg(apply_M, b, x0, diag_inv, abs_tol: float, max_iterations: int,
         rel_tol: float = 0.0):
    """Batched Jacobi-preconditioned CG with per-lane convergence masking
    (the JAX package's ``_pcg``, models/kkt.py:519-566).

    The tolerance floors at 10 ulps of ||b|| so float32 lanes terminate
    instead of stalling at a float64-era absolute tolerance; ``rel_tol`` > 0
    also stops at rel_tol * ||r0|| (the inexact-ADMM forcing term: with the
    warm-started x0, ||r0|| contracts as the outer iteration converges).

    JAX's ``lax.while_loop`` becomes a host loop whose condition reads
    "every lane done" back from the device once per step (``_pcg.syncs``
    counts these reads, ``_pcg.steps`` the steps; inside a distributed
    solve the ranks agree on it, core/lockstep.py). A done lane takes
    alpha = beta = 0, so its x stays unchanged bit for bit.
    """
    dtype = b.dtype
    eps = torch.finfo(dtype).eps
    b_norm = torch.linalg.vector_norm(b, dim=-1)
    tol2 = torch.clamp(10 * eps * b_norm, min=abs_tol) ** 2

    r = b - apply_M(x0)
    if rel_tol > 0.0:
        r0n2 = (r * r).sum(-1)
        rel = torch.as_tensor(rel_tol, dtype=dtype, device=b.device)
        tol2 = torch.maximum(tol2, rel ** 2 * r0n2)
    zk = diag_inv * r
    p = zk
    rz = (r * zk).sum(-1)
    done = (r * r).sum(-1) <= tol2
    x = x0
    it = 0
    while it < max_iterations:
        _pcg.syncs += 1
        if not read_flags((~done).any().reshape(1))[0]:
            break
        Ap = apply_M(p)
        pAp = (p * Ap).sum(-1)
        alpha = torch.where(done | (pAp <= 0), 0.0,
                            rz / torch.where(pAp == 0, 1.0, pAp))
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * Ap
        zk = diag_inv * r
        rz1 = (r * zk).sum(-1)
        beta = torch.where(done | (rz == 0), 0.0,
                           rz1 / torch.where(rz == 0, 1.0, rz))
        p = zk + beta[..., None] * p
        done = done | ((r * r).sum(-1) <= tol2)
        rz = rz1
        it += 1
    _pcg.steps += it
    return x


_pcg.steps = 0
_pcg.syncs = 0


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Backend:
    init: Any
    refactor: Any
    solve: Any
    #: True when refactor is O(n) (iterative backends): the solver then
    #: calls it every chunk instead of only when a lane's rho tripped.
    cheap_refactor: bool = False


BACKENDS = {
    KKTBackendKind.CHOLESKY: Backend(cholesky_init, cholesky_refactor,
                                     cholesky_solve),
    KKTBackendKind.KKT_LDL: Backend(kkt_ldl_init, kkt_ldl_refactor,
                                    kkt_ldl_solve),
    KKTBackendKind.CG: Backend(cg_init, cg_refactor, cg_solve,
                               cheap_refactor=True),
    KKTBackendKind.KKT_MINRES: Backend(kkt_minres_init, kkt_minres_refactor,
                                       kkt_minres_solve, cheap_refactor=True),
}


def get_backend(kind: KKTBackendKind, qp) -> Backend:
    b = BACKENDS[resolve_backend(kind, qp)]
    # The functions as this module holds them at the solve's start, so a
    # counter put on one (chip_smoke.py counts cholesky_init's builds) sees
    # every call.
    here = globals()
    return dataclasses.replace(b, init=here[b.init.__name__],
                               refactor=here[b.refactor.__name__],
                               solve=here[b.solve.__name__])
