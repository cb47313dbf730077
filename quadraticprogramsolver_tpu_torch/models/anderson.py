"""Safeguarded Anderson acceleration of both families' fixed points
(counterpart of the JAX package's models/anderson.py).

The OSQP iteration is Douglas-Rachford splitting in ``s = (x, w)`` with
``w = z + y/rho``: every chunk output satisfies ``z = clip(w, l, u)`` and
``y = rho (w - z)``, so ``s`` decodes back to the constrained iterates.
Type-II Anderson acceleration (AA) extrapolates the chunk map
``g = T^K`` (K = check_interval) at check boundaries from a per-lane ring
buffer of the last ``anderson_memory`` difference pairs: the residual
``f_j = g(s_j) - s_j`` is the chunk's output minus its input, so the chunk
(and its kernel) is untouched. The mixing weights solve a batched M x M
Tikhonov-damped least-squares problem (``aa_gamma``).

Safeguard: a lane takes the mixed point only when its combined (primal,
dual) residual margin beats the plain chunk output's; a rejected lane's
history restarts and the plain iterate proceeds. A lane's history also
restarts when its rho is re-adopted (the encoding and the map change), and
an accepted step masks that check's fixed-point test (admm.py).

The prox-ALM variant lives at the bottom: after any full iteration its
(s, z) pair is the projection split of u = s - z/rho, so its fixed point
lives in (x, y, u) and decoding re-imposes the split exactly.

Everything is torch on the tensors' device; the extra products per check
(the plain point's Px and the mixed point's Ax, A'y, Px) are torch products.
"""

from __future__ import annotations

import torch

from ..core.state import SolverState, Status
from ..ops.linalg import inf_norm, mm, mv, mv_t
from . import kkt as kkt_mod


def init_aa(qp, settings):
    """Zeroed AA carry: ring buffers of iterate/residual differences."""
    return init_aa_vec(qp.batch_shape, qp.n + qp.m, settings.anderson_memory,
                       qp.dtype, qp.device)


def reset_aa(aa, mask):
    """Clear the history (not the stored previous point) of masked lanes."""
    if aa is None:
        return None
    m3 = mask[..., None, None]
    zero = torch.zeros((), dtype=aa["S"].dtype, device=aa["S"].device)
    return {
        "S": torch.where(m3, zero, aa["S"]),
        "F": torch.where(m3, zero, aa["F"]),
        "prev_s": aa["prev_s"],
        "prev_f": aa["prev_f"],
        "count": aa["count"].masked_fill(mask, 0),
    }


def init_aa_vec(batch, d, mem, dtype, device):
    """Zeroed AA carry for a fixed-point vector of width d."""
    kw = dict(dtype=dtype, device=device)
    batch = tuple(batch)
    return {
        "S": torch.zeros(batch + (mem, d), **kw),
        "F": torch.zeros(batch + (mem, d), **kw),
        "prev_s": torch.zeros(batch + (d,), **kw),
        "prev_f": torch.zeros(batch + (d,), **kw),
        "count": torch.zeros(batch, dtype=torch.int32, device=device),
    }


def aa_mix(aa, s_in, s_plain, mem, reg):
    """Push the new difference pair and return the type-II candidate.

    ``s_in`` is the point the map was applied at (the chunk input),
    ``s_plain`` its image. Returns ``(s_aa, S, F, f, have_prev)``; the
    caller decides acceptance and commits with :func:`aa_commit`.
    """
    f = s_plain - s_in
    have_prev = aa["count"] >= 1
    ds = s_in - aa["prev_s"]
    df = f - aa["prev_f"]
    # Ring-buffer push: a one-hot write of the lane's slot (slots hold valid
    # differences or the zeros they were reset to).
    slot = torch.where(have_prev, torch.remainder(aa["count"] - 1, mem),
                       torch.zeros_like(aa["count"]))
    onehot = torch.arange(mem, device=slot.device) == slot[..., None]
    push = (onehot & have_prev[..., None])[..., None]
    S = torch.where(push, ds[..., None, :], aa["S"])
    F = torch.where(push, df[..., None, :], aa["F"])

    # At the scope's precision, as the JAX package's einsums (:111-114).
    G = mm(F, F.transpose(-1, -2))
    rhs = mv(F, f)
    gamma = aa_gamma(G, rhs, mem, reg, s_in.dtype)
    s_aa = s_plain - mv_t(S + F, gamma)
    return s_aa, S, F, f, have_prev


def aa_gamma(G, rhs, mem, reg, dt):
    """Type-II AA mixing weights gamma = argmin ||f - F' gamma||,
    Tikhonov-damped relative to the Gram trace: zero history rows add
    nothing, and an all-zero history gives gamma = 0 (the plain iterate)."""
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / mem
    lam = reg * tr + 1e-30
    eye = torch.eye(mem, dtype=dt, device=G.device)
    Greg = G + lam[..., None, None] * eye
    return torch.linalg.solve(Greg, rhs.unsqueeze(-1)).squeeze(-1)


def aa_commit(aa, S, F, s_in, f, active, rejected):
    """Rejected lanes restart (clear the differences, keep this check's
    point as the fresh base); every active lane records (s_j, f_j) and
    advances."""
    r3 = rejected[..., None, None]
    a2 = active[..., None]
    zero = torch.zeros((), dtype=S.dtype, device=S.device)
    count = torch.where(active, aa["count"] + 1, aa["count"])
    return {
        "S": torch.where(r3, zero, S),
        "F": torch.where(r3, zero, F),
        "prev_s": torch.where(a2, s_in, aa["prev_s"]),
        "prev_f": torch.where(a2, f, aa["prev_f"]),
        "count": count.masked_fill(rejected, 1),
    }


def _rho_row(qp, settings, rho):
    return kkt_mod.rho_rows(qp, rho, settings).expand(
        qp.batch_shape + (qp.m,))


def _encode(qp, settings, x, z, y, rho):
    return torch.cat([x, z + y / _rho_row(qp, settings, rho)], dim=-1)


def _decode(qp, settings, s, rho):
    x = s[..., : qp.n]
    w = s[..., qp.n:]
    z = torch.minimum(torch.maximum(w, qp.l), qp.u)
    y = _rho_row(qp, settings, rho) * (w - z)
    return x, z, y


def _residual_margin(qp, settings, Ax, z, Px, ATy, term_scale=None):
    """max(res_prim/eps_prim, res_dual/eps_dual) per lane, the convergence
    test's relative scaling; with ``term_scale`` (Ruiz) on the unscaled
    residuals, where the termination tests run."""
    if term_scale is None:
        def unsc_p(v):
            return v
        unsc_d = unsc_p
    else:
        e_inv = 1.0 / term_scale.e
        dc_inv = 1.0 / (term_scale.d * term_scale.c[..., None])

        def unsc_p(v):
            return v * e_inv

        def unsc_d(v):
            return v * dc_inv
    res_prim = inf_norm(unsc_p(Ax - z))
    res_dual = inf_norm(unsc_d(Px + qp.q + ATy))
    max_prim = torch.maximum(inf_norm(unsc_p(Ax)), inf_norm(unsc_p(z)))
    max_dual = torch.maximum(
        torch.maximum(inf_norm(unsc_d(Px)), inf_norm(unsc_d(ATy))),
        inf_norm(unsc_d(qp.q)))
    eps_p = settings.eps_abs + settings.eps_rel * max_prim
    eps_d = settings.eps_abs + settings.eps_rel * max_dual
    return torch.maximum(res_prim / eps_p, res_dual / eps_d)


def aa_step(qp, settings, state: SolverState, x, z, y, chunk_prods,
            term_scale=None):
    """One guarded AA update at a check boundary.

    ``state`` is the pre-chunk state (its x/z/y are the chunk's input) and
    ``(x, z, y)`` the chunk's output. Returns ``(x, z, y, (Ax, ATy, Px),
    aa_new, accepted)`` with the per-lane selected iterates and their
    convergence-check products.
    """
    mem = settings.anderson_memory
    aa = state.aa
    active = state.status == Status.RUNNING

    s_in = _encode(qp, settings, state.x, state.z, state.y, state.rho)
    s_plain = _encode(qp, settings, x, z, y, state.rho)
    s_aa, S, F, f, have_prev = aa_mix(aa, s_in, s_plain, mem,
                                      settings.anderson_reg)
    x_a, z_a, y_a = _decode(qp, settings, s_aa, state.rho)

    if chunk_prods is None:
        Ax_p, ATy_p = qp.matvec_A(x), qp.matvec_At(y)
    else:
        Ax_p, ATy_p = chunk_prods
    Px_p = qp.matvec_P(x)
    Ax_a, ATy_a, Px_a = qp.matvec_A(x_a), qp.matvec_At(y_a), qp.matvec_P(x_a)
    m_plain = _residual_margin(qp, settings, Ax_p, z, Px_p, ATy_p, term_scale)
    m_aa = _residual_margin(qp, settings, Ax_a, z_a, Px_a, ATy_a, term_scale)
    accepted = active & have_prev & m_aa.isfinite() & (m_aa < m_plain)
    rejected = active & have_prev & ~accepted

    sel = accepted[..., None]
    x = torch.where(sel, x_a, x)
    z = torch.where(sel, z_a, z)
    y = torch.where(sel, y_a, y)
    Ax = torch.where(sel, Ax_a, Ax_p)
    ATy = torch.where(sel, ATy_a, ATy_p)
    Px = torch.where(sel, Px_a, Px_p)

    aa_new = aa_commit(aa, S, F, s_in, f, active, rejected)
    return x, z, y, (Ax, ATy, Px), aa_new, accepted


# --- prox-ALM variant -----------------------------------------------------


def init_aa_proxqp(prob, settings):
    return init_aa_vec(prob.batch_shape, prob.n + prob.n_eq + prob.n_ineq,
                       settings.anderson_memory, prob.dtype, prob.device)


def _encode_proxqp(x, y, s, z, rho):
    return torch.cat([x, y, s - z / rho[..., None]], dim=-1)


def _decode_proxqp(prob, v, rho):
    n, me = prob.n, prob.n_eq
    x = v[..., :n]
    y = v[..., n:n + me]
    u = v[..., n + me:]
    s = torch.clamp_min(u, 0.0)
    z = rho[..., None] * torch.clamp_min(-u, 0.0)
    return x, y, s, z


def _proxqp_products(prob, x, y, z):
    return {"Px": prob.matvec_P(x), "Aty": prob.matvec_At(y),
            "Ctz": prob.matvec_Ct(z), "Ax": prob.matvec_A(x),
            "Cx": prob.matvec_C(x)}


def _proxqp_margin(prob, settings, pr, s):
    """PIQP 13a-c residuals collapsed to one relative margin per lane."""
    batch = pr["Px"].shape[:-1]
    res_prim = torch.maximum(inf_norm(pr["Ax"] - prob.b),
                             inf_norm(pr["Cx"] - prob.d + s))
    res_dual = inf_norm(pr["Px"] + pr["Aty"] + pr["Ctz"] + prob.q)
    max_prim = torch.stack([
        inf_norm(pr["Ax"]), inf_norm(prob.b).expand(batch), inf_norm(pr["Cx"]),
        inf_norm(prob.d).expand(batch), inf_norm(s)]).amax(0)
    max_dual = torch.stack([
        inf_norm(pr["Px"]), inf_norm(pr["Aty"]), inf_norm(pr["Ctz"]),
        inf_norm(prob.q).expand(batch)]).amax(0)
    eps_p = settings.eps_abs + settings.eps_rel * max_prim
    eps_d = settings.eps_abs + settings.eps_rel * max_dual
    return torch.maximum(res_prim / eps_p, res_dual / eps_d)


def aa_step_proxqp(prob, settings, aa, rho, active,
                   x_in, s_in_, y_in, z_in, x, s, y, z):
    """Guarded AA update of the prox-ALM chunk map.

    ``*_in`` is the chunk's input point, ``(x, s, y, z)`` its output.
    Returns the per-lane selected iterates, their convergence-check
    products, the new carry and the accept mask.
    """
    v_in = _encode_proxqp(x_in, y_in, s_in_, z_in, rho)
    v_plain = _encode_proxqp(x, y, s, z, rho)
    v_aa, S, F, f, have_prev = aa_mix(aa, v_in, v_plain,
                                      settings.anderson_memory,
                                      settings.anderson_reg)
    x_a, y_a, s_a, z_a = _decode_proxqp(prob, v_aa, rho)

    pr_p = _proxqp_products(prob, x, y, z)
    pr_a = _proxqp_products(prob, x_a, y_a, z_a)
    m_plain = _proxqp_margin(prob, settings, pr_p, s)
    m_aa = _proxqp_margin(prob, settings, pr_a, s_a)
    accepted = active & have_prev & m_aa.isfinite() & (m_aa < m_plain)
    rejected = active & have_prev & ~accepted

    sel = accepted[..., None]
    x = torch.where(sel, x_a, x)
    s = torch.where(sel, s_a, s)
    y = torch.where(sel, y_a, y)
    z = torch.where(sel, z_a, z)
    prods = {k: torch.where(sel, pr_a[k], pr_p[k]) for k in pr_p}
    aa_new = aa_commit(aa, S, F, v_in, f, active, rejected)
    return x, s, y, z, prods, aa_new, accepted
