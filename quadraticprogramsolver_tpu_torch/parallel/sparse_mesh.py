"""One huge sparse QP with its rows split over the ranks (matrix-free PCG),
the sparse sibling of parallel/consensus.py (counterpart of the JAX
package's parallel/sparse_mesh.py).

  * A's rows are split: shard d holds the ELL row block A_d (m_loc, kA) with
    global column indices into the replicated x.
  * A' lives as per-shard column partials: shard d stores (A_d)' as its own
    row-ELL (n, kAt_d) whose columns index the LOCAL w_d, so A'w =
    psum_d((A_d)' w_d) is one ELL product and one all-reduce.
  * P is split the same way (P symmetric: column block d is row block d
    transposed), as per-shard column partials with global indices, so
    P v = psum_d((P_d)' v).
  * Row-space vectors (z, y, l, u) are split, n-space vectors replicated.

Every ELL product is ``ops/spmv.py: ell_matvec``, row 13's kernel on a card
(float32 values, int32 columns). The Jacobi-PCG (models/kkt.py: ``_pcg``)
runs on replicated n-vectors whose every cross-shard piece comes through the
all-reduce, so each rank computes the same iterates as the single-card
SparseQP solve; the check and Krylov loops' flags agree over the group
(core/lockstep.py). Adaptive rho, host Ruiz scaling (termination on the
unscaled residuals), the certificates, vector rho (the weighted Jacobi
diagonal is one scatter-add and one all-reduce a solve), Anderson (split
history, psum'd Gram, margins on unscaled residuals) and the MINRES polish
run distributed, as in JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from ..core.lockstep import lockstep, read_flags
from ..core.problem import default_device
from ..core.settings import RHO_MAX, RHO_MIN, Settings
from ..core.sparse_problem import _to_ell
from ..core.state import SolveInfo, Solution, Status
from ..models.anderson import aa_gamma
from ..models.kkt import _minres, _pcg
from ..ops.linalg import inf_norm, mm, mv, mv_t, products
from ..ops.spmv import ell_matvec
from .mesh import all_gather_cat, axis, make_mesh, rank_device, reducer

SPARSE_AXIS = "rows"


@dataclasses.dataclass(frozen=True)
class ShardedSparseQP:
    """Host-prepared shards, stacked on a leading (n_shards,) axis."""

    A_vals: torch.Tensor    # (D, m_loc, kA)  row block of A, global cols
    A_cols: torch.Tensor
    Atp_vals: torch.Tensor  # (D, n, kAt)     (A_d)' partial, LOCAL cols
    Atp_cols: torch.Tensor
    Ptp_vals: torch.Tensor  # (D, n, kP)      (P rows d)' partial, GLOBAL cols
    Ptp_cols: torch.Tensor
    q: torch.Tensor         # (n,) replicated
    l: torch.Tensor         # (D, m_loc)
    u: torch.Tensor         # (D, m_loc)
    dP: torch.Tensor        # (n,) replicated
    dAtA: torch.Tensor      # (n,) replicated
    e_scale: torch.Tensor   # (D, m_loc) Ruiz row scales (ones when unscaled)

    @property
    def n(self) -> int:
        return self.q.shape[0]

    @property
    def n_shards(self) -> int:
        return self.A_vals.shape[0]

    @property
    def dtype(self):
        return self.q.dtype


def shard_sparse_qp(P, q, A, l, u, n_shards: int, dtype=np.float32,
                    scaling=None, device=None) -> ShardedSparseQP:
    """Partition scipy-sparse (P, q, A, l, u) into row shards (host-side).

    Constraint rows pad to a multiple of ``n_shards`` with inert rows
    (all-zero, l = -inf, u = +inf); P's rows pad with zeros. ``scaling``: an
    optional ScalingData from ``equilibrate_sparse_host`` whose row scales
    ``e`` are split alongside (pass the SCALED matrices here, as for the
    single-card pre-scaled path). The tensors go to the CUDA card unless
    ``device`` says otherwise (no card: raises); a rank takes its shard to
    its own device in :func:`solve_sparse_mesh`.
    """
    dev = default_device(device)
    P = sp.csr_matrix(P).astype(dtype)
    A = sp.csr_matrix(A).astype(dtype)
    m, n = A.shape
    D = n_shards
    m_loc = -(-m // D)
    n_loc = -(-n // D)

    l_pad = np.full(D * m_loc, -np.inf)
    u_pad = np.full(D * m_loc, np.inf)
    l_pad[:m] = np.asarray(l, np.float64)
    u_pad[:m] = np.asarray(u, np.float64)
    e = np.ones(D * m_loc, dtype)
    if scaling is not None:
        e[:m] = np.asarray(torch.as_tensor(scaling.e).cpu(), dtype)

    A_pad = sp.vstack(
        [A, sp.csr_matrix((D * m_loc - m, n), dtype=dtype)], format="csr")
    P_pad = sp.vstack(
        [P, sp.csr_matrix((D * n_loc - n, n), dtype=dtype)], format="csr")

    Av, Ac, Atv, Atc, Pv, Pc = [], [], [], [], [], []
    for d in range(D):
        Ad = A_pad[d * m_loc:(d + 1) * m_loc]
        v, c = _to_ell(Ad, dtype)
        Av.append(v)
        Ac.append(c)
        v, c = _to_ell(Ad.T.tocsr(), dtype)   # (n, kAt_d), cols in [0, m_loc)
        Atv.append(v)
        Atc.append(c)
        # (P rows d)' = P's column block d (n, n_loc), applied to the whole
        # replicated v: shift its local column indices to global.
        v, c = _to_ell(P_pad[d * n_loc:(d + 1) * n_loc].T.tocsr(), dtype)
        c = np.where(v != 0, c + d * n_loc, 0).astype(np.int32)
        Pv.append(v)
        Pc.append(c)

    def stack_pad(blocks):
        k = max(b.shape[-1] for b in blocks)
        return torch.tensor(np.stack(
            [np.pad(b, [(0, 0), (0, k - b.shape[-1])]) for b in blocks]),
            device=dev)

    def t(a):
        return torch.tensor(np.asarray(a, dtype), device=dev)

    dAtA = np.asarray(A.multiply(A).sum(axis=0)).ravel()
    return ShardedSparseQP(
        A_vals=stack_pad(Av), A_cols=stack_pad(Ac),
        Atp_vals=stack_pad(Atv), Atp_cols=stack_pad(Atc),
        Ptp_vals=stack_pad(Pv), Ptp_cols=stack_pad(Pc),
        q=t(q), l=t(l_pad.reshape(D, m_loc)), u=t(u_pad.reshape(D, m_loc)),
        dP=t(P.diagonal()), dAtA=t(dAtA), e_scale=t(e.reshape(D, m_loc)))


def _zero_carry(sq: ShardedSparseQP, settings: Settings, device=None):
    """Fresh solve-space carry (x, z, y, rho, rho_cand[, aa]): the state a
    cold solve starts from and a segment boundary hands on. Row-space
    entries are stacked over the shards (D, ...), as the problem's are."""
    n, D, m_loc = sq.n, sq.n_shards, sq.l.shape[-1]
    kw = dict(dtype=sq.dtype, device=sq.q.device if device is None else device)
    rho = torch.tensor(settings.rho, **kw)
    carry = {"x": torch.zeros((n,), **kw), "z": torch.zeros((D, m_loc), **kw),
             "y": torch.zeros((D, m_loc), **kw), "rho": rho,
             "rho_cand": rho.clone()}
    mem = settings.anderson_memory
    if mem > 0:
        carry["aa"] = {
            "Sx": torch.zeros((mem, n), **kw), "Fx": torch.zeros((mem, n), **kw),
            "Sw": torch.zeros((D, mem, m_loc), **kw),
            "Fw": torch.zeros((D, mem, m_loc), **kw),
            "px": torch.zeros((n,), **kw), "fx": torch.zeros((n,), **kw),
            "pw": torch.zeros((D, m_loc), **kw),
            "fw": torch.zeros((D, m_loc), **kw),
            "count": torch.zeros((), dtype=torch.int32, device=kw["device"]),
        }
    return carry


#: The carry entries split over the shards (the rest are replicated).
_SPLIT = ("z", "y", "Sw", "Fw", "pw", "fw")


def _carry_local(carry, r, dev):
    """This rank's view of a stacked carry: split entries at shard r."""
    out = {}
    for k, v in carry.items():
        if isinstance(v, dict):
            out[k] = _carry_local(v, r, dev)
        else:
            v = torch.as_tensor(v)
            out[k] = (v[r] if k in _SPLIT else v).to(dev)
    return out


def _carry_gather(carry, group):
    """The stacked carry from every rank's view (split entries gathered)."""
    out = {}
    for k, v in carry.items():
        if isinstance(v, dict):
            out[k] = _carry_gather(v, group)
        elif k in _SPLIT:
            out[k] = all_gather_cat(v[None], group, 0)
        else:
            out[k] = v
    return out


def solve_sparse_mesh(sq: ShardedSparseQP, settings: Settings = Settings(),
                      mesh=None, m_orig: int | None = None, scaling=None,
                      carry=None, return_carry: bool = False):
    """Solve the row-split sparse QP: models/admm.py's CG path, check for
    check the single-card SparseQP solve. Every rank passes the whole
    :class:`ShardedSparseQP` and uses its own shard; the mesh is 1-D with
    one rank a shard (default: the world, on the cards).

    ``scaling``: the ScalingData whose matrices ``sq`` was built from
    (termination then runs on unscaled residuals and the solution comes back
    unscaled, as with ``solve(scaling=...)``). ``carry``/``return_carry``:
    warm-start from / hand back the raw solve-space state (x, z, y, rho,
    rho_cand[, aa]), the interface :func:`solve_sparse_mesh_segmented` builds
    on; the carry is taken before polish.
    """
    if mesh is None:
        mesh = make_mesh((sq.n_shards,), (SPARSE_AXIS,))
    r, D, group = axis(mesh, mesh.mesh_dim_names[0])
    if D != sq.n_shards:
        raise ValueError(f"mesh has {D} devices, data has "
                         f"{sq.n_shards} shards")
    with products(settings.matmul_precision), lockstep(group):
        return _solve(sq, settings, r, group, rank_device(mesh), m_orig,
                      scaling, carry, return_carry)


def _solve(sq, settings, r, group, dev, m_orig, scaling, carry,
           return_carry):
    n = sq.n
    m_loc = sq.l.shape[-1]
    m_out = m_loc * sq.n_shards if m_orig is None else m_orig
    dt = sq.dtype
    kw = dict(dtype=dt, device=dev)
    zero = torch.zeros((), **kw)
    one = zero + 1.0

    def mine(t):
        return t[r].to(dev).contiguous()

    A_vals, A_cols = mine(sq.A_vals), mine(sq.A_cols)
    Atp_vals, Atp_cols = mine(sq.Atp_vals), mine(sq.Atp_cols)
    Ptp_vals, Ptp_cols = mine(sq.Ptp_vals), mine(sq.Ptp_cols)
    l, u, e_scale = mine(sq.l), mine(sq.u), mine(sq.e_scale)
    q, dP, dAtA = (t.to(dev) for t in (sq.q, sq.dP, sq.dAtA))
    sigma = settings.sigma_for(dt)
    alpha, alpha1 = settings.alpha, 1.0 - settings.alpha
    if scaling is not None:
        d_scale = scaling.d.to(**kw)
        c_scale = scaling.c.to(**kw)
    else:
        d_scale = torch.ones((n,), **kw)
        c_scale = one

    # Maxima reduced together are exact; a check's go in one collective.
    psum = reducer(group, dist.ReduceOp.SUM)
    pmax = reducer(group, dist.ReduceOp.MAX)

    def matvec_A(v):                                     # (m_loc,) local
        return ell_matvec(A_vals, A_cols, v.contiguous())

    def matvec_At(w):                                    # (n,) replicated
        return psum(ell_matvec(Atp_vals, Atp_cols, w.contiguous()))

    def matvec_P(v):                                     # (n,) replicated
        return psum(ell_matvec(Ptp_vals, Ptp_cols, v.contiguous()))

    # Vector rho (models/kkt.py: row_weights): weights from each row's own
    # bounds; the weighted Jacobi diagonal diag(A'WA) is one scatter-add over
    # the local ELL block (padded slots add zeros to column 0) and one psum.
    w = None
    dAtA_w = dAtA
    if settings.rho_eq_scale != 1.0:
        tol_eq = 1e-9 * torch.clamp(u.abs(), min=1.0)
        is_eq = l.isfinite() & u.isfinite() & ((u - l).abs() <= tol_eq)
        w = torch.where(is_eq, one * settings.rho_eq_scale, one)
        dAtA_w = psum(torch.zeros((n,), **kw).index_add_(
            0, A_cols.reshape(-1).long(),
            (A_vals * A_vals * w[:, None]).reshape(-1)))

    def rho_rows(rho):
        return rho if w is None else rho * w             # scalar | (m_loc,)

    def apply_M(rho_row):
        # P's and A''s partials summed on the rank, then one all-reduce: a
        # CG step makes one collective for its product (JAX makes two).
        def apply(v):
            v = v.contiguous()
            part = (ell_matvec(Ptp_vals, Ptp_cols, v)
                    + ell_matvec(Atp_vals, Atp_cols,
                                 (rho_row * matvec_A(v)).contiguous()))
            return psum(part) + sigma * v

        return apply

    def diag_inv(rho):
        dvec = dP + sigma + rho * dAtA_w
        return torch.where(dvec > 0, 1.0 / dvec, one)

    # Unscaled-residual maps (identity when unscaled); row-space vectors are
    # local shards, so e_scale is the local slice.
    e_inv = 1.0 / e_scale
    dc_inv = 1.0 / (d_scale * c_scale)

    def unsc_p(v):
        return v * e_inv

    def unsc_d(v):
        return v * dc_inv

    def unsc_x(v):
        return v * d_scale

    if carry is None:
        carry = _zero_carry(sq, settings, dev)
    c0 = _carry_local(carry, r, dev)
    x, z, y = c0["x"], c0["z"], c0["y"]
    rho, rho_cand = c0["rho"], c0["rho_cand"]
    aa = c0.get("aa")
    mem = settings.anderson_memory
    xx_c = torch.zeros((n,), **kw)
    status = torch.zeros((), dtype=torch.int32, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    rp = rd = torch.tensor(float("inf"), **kw)
    # Products at the carry for the certificate deltas (zeros on a cold
    # start; a warm-started segment sees its own).
    Px_p, Ax_p, ATy_p = matvec_P(x), matvec_A(x), matvec_At(y)
    max_total = settings.num_checks * settings.check_interval
    it = 0
    while it < max_total:
        if not read_flags((status == Status.RUNNING).reshape(1))[0]:
            break
        running = status == Status.RUNNING
        if settings.adaptive_rho:
            f = settings.rho_factor
            trip = (rho_cand * f < rho) | (rho_cand > f * rho)
            rho = torch.where(trip, rho_cand, rho)
            if aa is not None:
                # A re-adopted rho changes the w = z + y/rho encoding.
                for k in ("Sx", "Fx", "Sw", "Fw"):
                    aa[k] = torch.where(trip, zero, aa[k])
                aa["count"] = torch.where(trip, torch.zeros_like(aa["count"]),
                                          aa["count"])
        dinv = diag_inv(rho)
        rho_row = rho_rows(rho)
        x_start, z_start, y_start = x, z, y
        for _ in range(settings.check_interval):
            b = sigma * x - q + matvec_At(rho_row * z - y)
            xx = _pcg(apply_M(rho_row), b, xx_c, dinv,
                      abs_tol=settings.cg_eps,
                      max_iterations=settings.cg_max_iterations,
                      rel_tol=settings.cg_rel_eps)
            zz = matvec_A(xx)
            xp, zp = x, z
            x = alpha * xx + alpha1 * xp
            z = torch.minimum(torch.maximum(alpha * zz + alpha1 * zp
                                            + y / rho_row, l), u)
            y = y + rho_row * (alpha * zz + alpha1 * zp - z)
            xx_c = xx
        it += settings.check_interval

        aa_accept = None
        if aa is not None:
            # The guarded Anderson step in the split coordinates, its
            # safeguard margins on UNSCALED residuals (models/anderson.py).
            w_in = z_start + y_start / rho_row
            w_pl = z + y / rho_row
            fx = x - x_start
            fw = w_pl - w_in
            have = aa["count"] >= 1
            slot = torch.where(have, torch.remainder(aa["count"] - 1, mem),
                               torch.zeros_like(aa["count"]))
            push = ((torch.arange(mem, device=dev) == slot) & have)[:, None]
            Sx = torch.where(push, (x_start - aa["px"])[None, :], aa["Sx"])
            Fx = torch.where(push, (fx - aa["fx"])[None, :], aa["Fx"])
            Sw = torch.where(push, (w_in - aa["pw"])[None, :], aa["Sw"])
            Fw = torch.where(push, (fw - aa["fw"])[None, :], aa["Fw"])
            Gw, rw = psum(mm(Fw, Fw.T), mv(Fw, fw))
            G = mm(Fx, Fx.T) + Gw
            rhs_g = mv(Fx, fx) + rw
            gamma = aa_gamma(G, rhs_g, mem, settings.anderson_reg, dt)
            x_a = x - mv_t(Sx + Fx, gamma)
            w_a = w_pl - mv_t(Sw + Fw, gamma)
            z_a = torch.minimum(torch.maximum(w_a, l), u)
            y_a = rho_row * (w_a - z_a)

            def margin(xv, zv, yv):
                Axv, Pxv, ATyv = matvec_A(xv), matvec_P(xv), matvec_At(yv)
                rpv, a_n, z_n = pmax(torch.stack([inf_norm(unsc_p(v)) for v in (
                    Axv - zv, Axv, zv)]))
                rdv = inf_norm(unsc_d(Pxv + q + ATyv))
                mpv = torch.maximum(a_n, z_n)
                mdv = torch.maximum(
                    torch.maximum(inf_norm(unsc_d(Pxv)),
                                  inf_norm(unsc_d(ATyv))),
                    inf_norm(unsc_d(q)))
                marg = torch.maximum(
                    rpv / (settings.eps_abs + settings.eps_rel * mpv),
                    rdv / (settings.eps_abs + settings.eps_rel * mdv))
                return marg, (Axv, Pxv, ATyv)

            m_p, pr_p = margin(x, z, y)
            m_a, pr_a = margin(x_a, z_a, y_a)
            aa_accept = running & have & m_a.isfinite() & (m_a < m_p)
            rejected = running & have & ~aa_accept
            x = torch.where(aa_accept, x_a, x)
            z = torch.where(aa_accept, z_a, z)
            y = torch.where(aa_accept, y_a, y)
            Ax, Px, ATy = (torch.where(aa_accept, a, p)
                           for a, p in zip(pr_a, pr_p))
            count = torch.where(running, aa["count"] + 1, aa["count"])
            aa = {"Sx": torch.where(rejected, zero, Sx),
                  "Fx": torch.where(rejected, zero, Fx),
                  "Sw": torch.where(rejected, zero, Sw),
                  "Fw": torch.where(rejected, zero, Fw),
                  "px": torch.where(running, x_start, aa["px"]),
                  "fx": torch.where(running, fx, aa["fx"]),
                  "pw": torch.where(running, w_in, aa["pw"]),
                  "fw": torch.where(running, fw, aa["fw"]),
                  "count": torch.where(rejected, torch.ones_like(count),
                                       count)}
        else:
            Ax, Px, ATy = matvec_A(x), matvec_P(x), matvec_At(y)
        (res_prim, ax_u, z_u, dz_u, rp_s, ax_s, z_s) = pmax(torch.stack([
            inf_norm(unsc_p(Ax - z)), inf_norm(unsc_p(Ax)),
            inf_norm(unsc_p(z)), inf_norm(unsc_p(z - z_start)),
            inf_norm(Ax - z), inf_norm(Ax), inf_norm(z)]))
        res_dual = inf_norm(unsc_d(Px + q + ATy))
        max_prim = torch.maximum(ax_u, z_u)
        max_dual = torch.maximum(
            torch.maximum(inf_norm(unsc_d(Px)), inf_norm(unsc_d(ATy))),
            inf_norm(unsc_d(q)))

        if settings.adaptive_rho:
            # rho adapts on the solve-space residuals (models/admm.py).
            rd_s = inf_norm(Px + q + ATy)
            mp_s = torch.maximum(ax_s, z_s)
            md_s = torch.maximum(torch.maximum(inf_norm(Px), inf_norm(ATy)),
                                 inf_norm(q))
            den = rd_s * mp_s
            cand = torch.clamp(
                rho * torch.sqrt(rp_s * md_s / torch.where(den == 0, one, den)),
                RHO_MIN, RHO_MAX)
            ok = cand.isfinite() & (den != 0) & (cand > 0)
            rho_cand = torch.where(running & ok, cand, rho_cand)

        eps_prim = settings.eps_abs + settings.eps_rel * max_prim
        eps_dual = settings.eps_abs + settings.eps_rel * max_dual
        solved = (res_prim < eps_prim) & (res_dual < eps_dual)
        ulp = 8 * torch.finfo(dt).eps
        fp = ((inf_norm(unsc_x(x - x_start))
               <= settings.eps_admm
               + ulp * torch.clamp(inf_norm(unsc_x(x)), min=1.0))
              & (dz_u <= settings.eps_admm + ulp * torch.clamp(z_u, min=1.0)))
        if aa_accept is not None:
            # An accepted AA step compares x against another map's point.
            fp &= ~aa_accept
        status = status.masked_fill(running & solved, int(Status.SOLVED))
        status = status.masked_fill(running & fp, int(Status.SOLVED_ADMM))
        if settings.check_infeasibility:
            status = _certificates(
                settings, status, running, x, y, x_start, y_start, Ax, Px, ATy,
                Ax_p, Px_p, ATy_p, q, l, u, res_prim, res_dual, eps_prim,
                eps_dual, psum, pmax)
        iters = torch.where(running & (status != Status.RUNNING),
                            torch.tensor(it, dtype=torch.int32, device=dev),
                            iters)
        rp = torch.where(running, res_prim, rp)
        rd = torch.where(running, res_dual, rd)
        Px_p, Ax_p, ATy_p = Px, Ax, ATy

    # The raw solve-space carry for a segment's successor, before polish
    # (polish refines the reported solution, not the iteration).
    carry_out = {"x": x, "z": z, "y": y, "rho": rho, "rho_cand": rho_cand}
    if aa is not None:
        carry_out["aa"] = aa
    exhausted = status == Status.RUNNING
    status = status.masked_fill(exhausted, int(Status.MAX_ITERATIONS))
    iters = torch.where(exhausted,
                        torch.tensor(it, dtype=torch.int32, device=dev), iters)

    if settings.polish_iterations > 0:
        x, y = _polish(settings, x, z, y, q, l, u, dP, matvec_A, matvec_At,
                       matvec_P, psum, pmax)

    # Unscale the returned iterates (solve(scaling=...) semantics).
    x_u = x * d_scale
    z_u = z * e_inv
    y_u = y * e_scale / c_scale
    obj = (0.5 * (x_u * (matvec_P(x) / (d_scale * c_scale))).sum()
           + ((q / (d_scale * c_scale)) * x_u).sum())
    z_u = all_gather_cat(z_u, group)[:m_out]
    y_u = all_gather_cat(y_u, group)[:m_out]
    info = SolveInfo(status=status, iterations=iters, res_prim=rp,
                     res_dual=rd, rho=rho, objective=obj)
    sol = Solution(x=x_u, z=z_u, y=y_u, info=info)
    if return_carry:
        return sol, _carry_gather(carry_out, group)
    return sol


def _certificates(settings, status, running, x, y, x_start, y_start, Ax, Px,
                  ATy, Ax_p, Px_p, ATy_p, q, l, u, res_prim, res_dual,
                  eps_prim, eps_dual, psum, pmax):
    """OSQP section 3.4 certificates with the row-space pieces reduced over
    the ranks (parallel/consensus.py's, one instance)."""
    dt = x.dtype
    zero = torch.zeros((), dtype=dt, device=x.device)
    inf = torch.tensor(float("inf"), dtype=dt, device=x.device)
    eps_p, eps_d = settings.eps_prim_inf, settings.eps_dual_inf
    dy = y - y_start
    dx = x - x_start
    ndy, y_n = pmax(torch.stack([inf_norm(dy), inf_norm(y)]))
    pos = torch.clamp(dy, min=0.0)
    neg = torch.clamp(dy, max=0.0)
    tol = eps_p * ndy
    fin_l, fin_u = l.isfinite(), u.isfinite()
    term_u = torch.where(fin_u, u * pos, torch.where(pos > tol, inf, zero))
    term_l = torch.where(fin_l, l * neg, torch.where(neg < -tol, inf, zero))
    ndx = inf_norm(dx)
    Adx = Ax - Ax_p
    tol_d = eps_d * ndx
    ok_rows = torch.where(
        fin_l & fin_u, Adx.abs() <= tol_d,
        torch.where(fin_l, Adx >= -tol_d,
                    torch.where(fin_u, Adx <= tol_d, torch.ones_like(fin_l))))
    # The support and the count of failing rows (exact in floating point) in
    # one collective.
    support, bad = psum(torch.stack([(term_u + term_l).sum(),
                                     (~ok_rows).to(dt).sum()]))
    all_ok = bad == 0
    prim_inf = ((ndy > 0) & (inf_norm(ATy - ATy_p) <= eps_p * ndy)
                & (support <= -eps_p * ndy))
    dual_inf = ((ndx > 0) & (inf_norm(Px - Px_p) <= eps_d * ndx)
                & ((q * dx).sum() <= -eps_d * ndx) & all_ok)
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


def _polish(settings, x, z, y, q, l, u, dP, matvec_A, matvec_At, matvec_P,
            psum, pmax):
    """The distributed MINRES polish in the solve space (where the
    single-card path polishes a scaled problem): models/polish.py:
    polish_minres with psum'd Lanczos inner products and pmax'd acceptance
    metrics, the sparse sibling of consensus.py's."""
    dt = x.dtype
    n = x.shape[0]
    delta = settings.delta
    zero = torch.zeros((), dtype=dt, device=x.device)
    one = zero + 1.0
    cprox = 10.0 * torch.clamp(pmax(inf_norm(matvec_A(x) - z)),
                               min=settings.eps_abs)
    low_active = (y < 0) & l.isfinite() & (z - l <= cprox * (1.0 + l.abs()))
    up_active = (y > 0) & u.isfinite() & (u - z <= cprox * (1.0 + u.abs()))
    act_rows = low_active | up_active
    g = torch.where(low_active, l, zero) + torch.where(up_active, u, zero)
    r_diag = torch.where(act_rows, one * delta, one)

    def apply_K(v):
        v1, v2 = v[:n], v[n:]
        top = (matvec_P(v1) + delta * v1
               + matvec_At(torch.where(act_rows, v2, zero)))
        bot = torch.where(act_rows, matvec_A(v1), zero) - r_diag * v2
        return torch.cat([top, bot])

    def apply_K_exact(v):
        v1, v2 = v[:n], v[n:]
        top = matvec_P(v1) + matvec_At(torch.where(act_rows, v2, zero))
        bot = (torch.where(act_rows, matvec_A(v1), zero)
               - torch.where(act_rows, zero, v2))
        return torch.cat([top, bot])

    d1 = dP + delta
    d1_inv = torch.where(d1 > 0, 1.0 / d1, one)

    def precond(v):
        return torch.cat([d1_inv * v[:n], v[n:] / r_diag])

    def vdot(a, b):
        # The x-part is replicated, the nu-part split: psum only the split
        # part, so the Lanczos scalars are the global inner products.
        return (a[:n] * b[:n]).sum() + psum((a[n:] * b[n:]).sum())

    def kkt_err(xv, yv):
        Axv = matvec_A(xv)
        dual = inf_norm(matvec_P(xv) + q + matvec_At(yv))
        viol = pmax(inf_norm(Axv - torch.minimum(torch.maximum(Axv, l), u)))
        return torch.maximum(dual, viol)

    b_rhs = torch.cat([-q, g])
    v = torch.cat([x, torch.where(act_rows, y, zero)])
    for _ in range(max(1, settings.polish_iterations)):
        r = b_rhs - apply_K_exact(v)
        v = v + _minres(apply_K, precond, r, torch.zeros_like(b_rhs),
                        abs_tol=0.0, max_iterations=settings.polish_max_krylov,
                        vdot=vdot, rel_tol=settings.polish_eps)
    px, pn = v[:n], v[n:]
    finite = (px.isfinite().all()
              & (psum((~pn.isfinite()).to(torch.int32).sum()) == 0))
    accept = (kkt_err(px, pn) < kkt_err(x, y)) & finite
    return torch.where(accept, px, x), torch.where(accept, pn, y)


def solve_sparse_mesh_segmented(sq: ShardedSparseQP,
                                settings: Settings = Settings(), mesh=None,
                                m_orig: int | None = None, scaling=None,
                                segment_iterations: int = 100,
                                callback=None) -> Solution:
    """Bounded solves over the mesh with a warm-start carry, the distributed
    sibling of models/admm.py: solve_segmented. Anderson history, the
    adaptive-rho state and the certificates' products ride the carry, so
    the segmented trajectory is the monolithic one check for check when
    ``segment_iterations`` is a multiple of ``check_interval``.

    ``callback(segment_index, solution, carry)``: an optional hook a
    segment (checkpointing, logging); returning False stops early.
    """
    total_budget = settings.max_iterations
    carry = None
    total_iters = 0
    seg_idx = 0
    sol = None
    while total_budget > 0:
        seg = dataclasses.replace(
            settings, max_iterations=min(segment_iterations, total_budget))
        sol, carry = solve_sparse_mesh(sq, seg, mesh, m_orig, scaling,
                                       carry=carry, return_carry=True)
        total_iters += int(sol.info.iterations)
        total_budget -= seg.max_iterations
        if callback is not None and callback(seg_idx, sol, carry) is False:
            break
        seg_idx += 1
        if int(sol.info.status) != Status.MAX_ITERATIONS:
            break
    info = dataclasses.replace(
        sol.info, iterations=torch.tensor(total_iters, dtype=torch.int32,
                                          device=sol.x.device))
    return Solution(x=sol.x, z=sol.z, y=sol.y, info=info)
