"""bench.py's tuned headline stacks in the port against the JAX package.

The stacks: bench.py's ``slab_settings`` (slab window, lanes 2, bf16x3 dots,
a one-pass bf16 first chunk, static rho 0.4) and ``slab_hi`` (slab window,
lanes 4, FP32 dots, the same schedule), the split stack (``slab_settings``
with the pre-split bf16 G halves instead of the slab window and no
schedule), and the ``benchmarks/proxqp_fleet.py --headline`` prox stack
(lanes 2, bf16x3, the first-chunk schedule, static rho 0.0125). On the CPU
the port runs the kernels' plain versions; JAX runs its Pallas kernels in
interpret mode. Sizes: n = m = 128 (me = mi = 128), B = 4, K <= 11.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import quadraticprogramsolver_tpu as qps
from benchmarks import proxqp_fleet
from quadraticprogramsolver_tpu.models import kkt as jax_kkt
from quadraticprogramsolver_tpu.models import plan as jax_plan
from quadraticprogramsolver_tpu.models import proxqp as jax_proxqp
from quadraticprogramsolver_tpu.ops.fused_admm import (
    fused_admm_chunk as jax_admm_chunk)
from quadraticprogramsolver_tpu.ops.fused_proxqp import (
    fused_proxqp_chunk as jax_prox_chunk)

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.models import kkt as pt_kkt
from quadraticprogramsolver_tpu_torch.ops import fused_admm, fused_proxqp
from quadraticprogramsolver_tpu_torch.ops.fused_factor import fused_factor_solve
from quadraticprogramsolver_tpu_torch.ops.linalg import bf16_split
from quadraticprogramsolver_tpu_torch.utils.interop import (
    prox_settings_from_dict, proxqp_from_numpy, qp_from_numpy,
    settings_from_dict)

B, N, K_ADMM, K_PROX = 4, 128, 5, 7
_, SLAB, SLAB_HI = bench.headline_settings(True)
SPLIT = dataclasses.replace(SLAB, slab_cache=False, split_cache=True,
                            first_chunk_dot_precision=None)
#: benchmarks/proxqp_fleet.py --headline (plus require_fused).
PROX = qps.ProxQPSettings(
    max_iterations=2000, eps_abs=5e-5, eps_rel=5e-5, rho=0.0125,
    adaptive_rho=False, kkt_warm_start=False, kkt_refinement_steps=0,
    check_interval=25, sigma_free_rhs=True, fused_chunk=True, chunk_lanes=2,
    chunk_dot_precision="high", first_chunk_dot_precision="default",
    require_fused=True)
ADMM_STACKS = {"slab_settings": SLAB, "slab_hi": SLAB_HI, "split": SPLIT}
STACKS = [*ADMM_STACKS, "prox_headline"]
#: JAX's names for the same routes.
NAMES = {"fused_pallas": "fused_kernel", "xla": "torch"}


def _port(st):
    d = dataclasses.asdict(st)
    if isinstance(st, qps.ProxQPSettings):
        return prox_settings_from_dict(d)
    return settings_from_dict(d)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _admm_fleet(dtype):
    return qps.pad_qp(qps.generate_batch(qps.ProblemClass.RANDOM_QP, batch=B,
                                         num_elements=100, seed=0,
                                         dtype=dtype), N, N)


def _prox_fleet(me=N, mi=N):
    """The headline family (benchmarks/proxqp_fleet.py) at n = 128, as
    float64 numpy arrays (P, q, A, b, C, d)."""
    prob = proxqp_fleet.device_fleet(B, N, me, mi, seed=0)
    return [np.asarray(getattr(prob, k), np.float64) for k in "PqAbCd"]


# ---------------------------------------------------------------- settings

def _kw(st):
    """The fields of a JAX settings object that are not at their default
    (a JAX KKTBackendKind is not the port's)."""
    return {k: v for k, v in dataclasses.asdict(st).items()
            if v != getattr(type(st)(), k)}


_HI = dict(fused_factor=True, sigma_free_rhs=True, kkt_refinement_steps=0,
           fused_chunk=True, adaptive_rho=False)
SETTINGS_CASES = {
    "slab alone": (qps.Settings, dict(slab_cache=True)),
    "slab at adaptive rho": (qps.Settings, {**_HI, "adaptive_rho": True,
                                            "slab_cache": True}),
    "split at highest": (qps.Settings, {**_HI, "split_cache": True}),
    "split with slab": (qps.Settings, {**_HI, "split_cache": True,
                                       "slab_cache": True,
                                       "chunk_dot_precision": "high"}),
    "first chunk bf16": (qps.Settings, dict(first_chunk_dot_precision="bf16")),
    "first chunk unfused": (qps.Settings,
                            dict(first_chunk_dot_precision="default")),
    "first chunk with split": (qps.Settings, {
        **_kw(SPLIT), "first_chunk_dot_precision": "default"}),
    "lanes 0": (qps.Settings, dict(chunk_lanes=0)),
    "prox lanes 0": (qps.ProxQPSettings, dict(chunk_lanes=0)),
    "prox first chunk bf16": (qps.ProxQPSettings,
                              dict(first_chunk_dot_precision="bf16")),
    "prox first chunk unfused": (qps.ProxQPSettings,
                                 dict(first_chunk_dot_precision="default")),
    **{f"stack {k}": (type(v), _kw(v)) for k, v in
       {**ADMM_STACKS, "prox_headline": PROX}.items()},
}


@pytest.mark.parametrize("case", list(SETTINGS_CASES))
def test_settings_accept_and_reject_what_jax_does(case):
    cls, kw = SETTINGS_CASES[case]
    port_cls = pt.ProxQPSettings if cls is qps.ProxQPSettings else pt.Settings
    try:
        cls(**kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            port_cls(**kw)
    else:
        port_cls(**kw)


# ------------------------------------------------------------ chunk parity

def _admm_chunk_case(seed=1):
    qp = _admm_fleet(np.float32)
    st = qps.Settings(rho=0.4, kkt_refinement_steps=0, sigma_free_rhs=True)
    cache = jax_kkt.cholesky_init(qp, jnp.full((B,), 0.4, jnp.float32),
                                  jnp.float32(1e-6), st)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N)).astype(np.float32)
    z, y = (rng.standard_normal((B, N)).astype(np.float32) for _ in range(2))
    rho_row = np.full((B, N), 0.4, np.float32)
    active = np.array([True, False, True, True])
    return qp, np.asarray(cache["G"]), np.asarray(cache["g"]), x, z, y, rho_row, active


ADMM_CHUNK_CASES = [("high", 2, "slab"), ("highest", 4, "slab"),
                    ("high", 4, "split")]


@pytest.mark.parametrize("prec,lanes,source", ADMM_CHUNK_CASES)
def test_admm_chunk_variant_matches_jax_and_its_identity(prec, lanes, source):
    """Within 1e-5 of each output's max of JAX's chunk (interpret mode); in
    the port, bit for bit the output of lanes 1 with a contiguous G at the
    same precision (split: at "high")."""
    qp, G, g, x, z, y, rho_row, active = _admm_chunk_case()
    vecs = (qp.l, qp.u, x, z, y, rho_row, active)
    kw = dict(K=K_ADMM, alpha=1.6)
    Gt = _t(G)
    if source == "slab":  # G is the first N columns of a wider slab
        junk = np.random.default_rng(2).standard_normal((B, N, 128))
        S = np.concatenate([G, junk.astype(np.float32)], axis=-1)
        jax_G, port_G, extra = S, _t(S), dict(slab=True)
        jax_extra = extra
    else:
        Ghi, Glo = bf16_split(Gt)
        jax_G = jnp.asarray(Ghi.float().numpy()).astype(jnp.bfloat16)
        jax_extra = dict(Glo=jnp.asarray(Glo.float().numpy()).astype(jnp.bfloat16))
        port_G, extra = Ghi, dict(Glo=Glo)
    ref = jax_admm_chunk(jax_G, qp.A, None, None, *vecs, sigma=1e-6,
                         sigma_free=True, g=g, lanes=lanes, dot_precision=prec,
                         interpret=True, **kw, **jax_extra)
    pvecs = [_t(v) for v in vecs[:-1]] + [torch.from_numpy(active)]
    out = fused_admm.fused_admm_chunk(port_G, _t(qp.A), _t(g), *pvecs, lanes=lanes,
                                      dot_precision=prec, **kw, **extra)
    base = fused_admm.fused_admm_chunk(Gt, _t(qp.A), _t(g), *pvecs,
                                       dot_precision=prec, **kw)
    names = ("x", "z", "y", "x_prev", "z_prev", "Ax", "ATy")
    for name, r, o, b0 in zip(names, ref, out, base):
        r = np.asarray(r)
        assert np.abs(r - o.numpy()).max() <= 1e-5 * np.abs(r).max(), name
        assert torch.equal(o, b0), name


@pytest.mark.parametrize("prec,lanes", [("high", 2), ("highest", 4)])
def test_prox_chunk_variant_matches_jax_and_lanes_one(prec, lanes):
    P, q, A, b, C, d = _prox_fleet()
    rho = np.array([0.0125, 0.02, 0.015, 0.025])
    Mn = P + rho[:, None, None] * (A.transpose(0, 2, 1) @ A
                                   + C.transpose(0, 2, 1) @ C)
    R = np.concatenate([A.transpose(0, 2, 1), C.transpose(0, 2, 1),
                        q[..., None]], axis=-1)
    X = np.linalg.solve(Mn, R).astype(np.float32)
    Ga, Gc, g = X[..., :N], X[..., N:2 * N], X[..., 2 * N]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, N)).astype(np.float32)
    s, z = (rng.random((B, N)).astype(np.float32) for _ in range(2))
    y = rng.standard_normal((B, N)).astype(np.float32)
    active = np.array([True, True, False, True])
    f32 = [a.astype(np.float32) for a in (A, C, b, d)]
    ref = jax_prox_chunk(Ga, f32[0], f32[1], None, None, f32[2], f32[3], x, s,
                         y, z, rho.astype(np.float32), active, K=K_PROX,
                         sigma=1e-2, lanes=lanes, sigma_free=True, Gc=Gc, g=g,
                         dot_precision=prec, interpret=True)
    args = (_t(X[..., :2 * N]), *map(_t, f32[:2]), _t(g), *map(_t, f32[2:]),
            *map(_t, (x, s, y, z, rho)), torch.from_numpy(active))
    out = fused_proxqp.fused_proxqp_chunk(*args, K=K_PROX, lanes=lanes,
                                          dot_precision=prec)
    base = fused_proxqp.fused_proxqp_chunk(*args, K=K_PROX, dot_precision=prec)
    for name, r, o, b0 in zip("xsyz", ref, out, base):
        r = np.asarray(r)
        assert np.abs(r - o.numpy()).max() <= 1e-5 * np.abs(r).max(), name
        assert torch.equal(o, b0), name


def _bf(a):
    """a (float32) rounded to bf16, as float64."""
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16).double().numpy()


@pytest.mark.parametrize("family", ["admm", "prox"])
def test_default_precision_is_one_bf16_pass(family):
    """JAX's interpret mode computes "default" in full f32 on the CPU, so it
    cannot witness the rounding: one iteration of the plain "default" chunk
    against an f64 recomputation from the bf16-rounded operands, and
    against "highest", from which it must differ by more than 1e-4 of each
    output (a port that skipped the rounding would not)."""
    f32 = np.float32
    if family == "admm":
        qp, G, g, x, z, y, rho_row, active = _admm_chunk_case(4)
        A, l, u = (np.asarray(v) for v in (qp.A, qp.l, qp.u))
        args = [_t(v) for v in (G, A, g, l, u, x, z, y, rho_row)]
        run = lambda prec: fused_admm.fused_admm_chunk(  # noqa: E731
            *args, torch.ones(B, dtype=torch.bool), K=1, alpha=1.6,
            dot_precision=prec)
        t = (rho_row * z - y).astype(f32)
        xx = (np.einsum("bij,bj->bi", _bf(G), _bf(t)) - g).astype(f32)
        zz = np.einsum("bij,bj->bi", _bf(A), _bf(xx)).astype(f32)
        x1 = (f32(1.6) * xx + f32(1 - 1.6) * x).astype(f32)
        zr = (f32(1.6) * zz + f32(1 - 1.6) * z).astype(f32)
        z1 = np.clip(zr + (1 / rho_row) * y, l, u).astype(f32)
        y1 = (y + rho_row * (zr - z1)).astype(f32)
        want = (x1, z1, y1, x, z, np.einsum("bij,bj->bi", _bf(A), _bf(x1)),
                np.einsum("bj,bji->bi", _bf(y1), _bf(A)))
    else:
        P, q, A, b, C, d = (a.astype(f32) for a in _prox_fleet())
        rho = np.full(B, 0.0125, f32)
        X = np.linalg.solve(
            (P + rho[0] * (A.transpose(0, 2, 1) @ A + C.transpose(0, 2, 1) @ C)
             ).astype(np.float64),
            np.concatenate([A.transpose(0, 2, 1), C.transpose(0, 2, 1)],
                           axis=-1).astype(np.float64)).astype(f32)
        rng = np.random.default_rng(5)
        x, y = (rng.standard_normal((B, N)).astype(f32) for _ in range(2))
        s, z = (rng.random((B, N)).astype(f32) for _ in range(2))
        g = rng.standard_normal((B, N)).astype(f32)
        args = [_t(v) for v in (X, A, C, g, b, d, x, s, y, z, rho)]
        run = lambda prec: fused_proxqp.fused_proxqp_chunk(  # noqa: E731
            *args, torch.ones(B, dtype=torch.bool), K=1, dot_precision=prec)
        r = rho[:, None]
        t = np.concatenate([r * b - y, r * (d - s) - z], axis=-1).astype(f32)
        x1 = (np.einsum("bij,bj->bi", _bf(X), _bf(t)) - g).astype(f32)
        Cx = np.einsum("bij,bj->bi", _bf(C), _bf(x1)).astype(f32)
        Ax = np.einsum("bij,bj->bi", _bf(A), _bf(x1)).astype(f32)
        s1 = np.maximum(d - Cx - (1 / r) * z, 0).astype(f32)
        want = (x1, s1, (y + r * (Ax - b)).astype(f32),
                np.maximum(z + r * (Cx - d + s1), 0).astype(f32))
    got, full = run("default"), run("highest")
    for w, o in zip(want, got):
        assert np.abs(o.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    # x_prev and z_prev of one ADMM iteration are its inputs.
    moved = [float((o - h).abs().max()) / float(h.abs().max())
             for o, h in zip(got, full) if not torch.equal(h, o)]
    assert len(moved) == len(got) - (2 if family == "admm" else 0)
    assert min(moved) > 1e-4, moved


def test_split_cache_low_half_is_not_zero():
    """The split cache's halves: Glo is nonzero exactly where G is not
    bf16-exact, and Ghi + Glo reconstructs G to ~2^-16."""
    qp_j = _admm_fleet(np.float32)
    qp = qp_from_numpy(*(np.asarray(getattr(qp_j, k)) for k in "PqAlu"),
                       device="cpu", dtype=torch.float32)
    st = _port(SPLIT)
    rho = torch.full((B,), st.rho)
    cache = pt_kkt.cholesky_init(qp, rho, st.sigma_for(qp.dtype), st)
    S = fused_factor_solve(qp.P, qp.A, qp.q, rho[:, None].expand(B, N).contiguous(),
                           sigma=st.sigma)
    G = S[..., :N]
    Ghi, Glo = cache["Ghi"].float(), cache["Glo"].float()
    assert cache["Ghi"].dtype == cache["Glo"].dtype == torch.bfloat16
    assert torch.equal(Glo != 0, G != Ghi)
    assert int((Glo != 0).sum()) > int((G != 0).sum()) // 2
    assert float((Ghi + Glo - G).abs().max()) <= 2 ** -16 * float(G.abs().max())
    assert torch.equal(cache["g"], S[..., N])


# ------------------------------------------------------------ solve parity

def _solve_pair(stack, dtype):
    """(port solution, JAX solution, check_interval) on the same fleet."""
    if stack == "prox_headline":
        # me = 32, mi = 96, padded to 128 by both solves: with me = n the
        # square A pins x at the f32 noise level and neither side converges.
        arrs = _prox_fleet(32, 96)
        st = PROX if dtype == np.float32 else dataclasses.replace(
            PROX, require_fused=False)
        ref = jax_proxqp.solve(qps.make_proxqp(*arrs, dtype=dtype), st)
        p = proxqp_from_numpy(*arrs, device="cpu",
                              dtype=getattr(torch, np.dtype(dtype).name))
        return pt.solve_proxqp(p, _port(PROX)), ref, PROX.check_interval
    st = ADMM_STACKS[stack]
    qp_j = _admm_fleet(dtype)
    st_j = st if dtype == np.float32 else dataclasses.replace(
        st, require_fused=False)  # JAX's f64 solve runs its XLA chunk
    ref = qps.solve_jit(qp_j, st_j)
    qp = qp_from_numpy(*(np.asarray(getattr(qp_j, k)) for k in "PqAlu"),
                       device="cpu", dtype=getattr(torch, np.dtype(dtype).name))
    return pt.solve(qp, _port(st)), ref, st.check_interval


@pytest.mark.parametrize("stack", STACKS)
def test_f32_stack_solve_matches_jax_interpret(stack):
    """Every lane converges on both sides, x agrees within 1e-3 * max(|x|,
    1) (the JAX package's own tolerance for its fused stacks), and each
    lane's iteration count is the same or one check interval apart. The
    split and prox stacks give the same counts; under slab_settings and
    slab_hi one lane of the four exits one check later in the port (33 vs
    22): their first chunk runs at "default", which the port rounds to bf16
    while JAX's interpret mode computes it in full f32."""
    sol, ref, ci = _solve_pair(stack, np.float32)
    ok = (3,) if stack == "prox_headline" else (2, 3)
    assert np.isin(sol.info.status.numpy(), ok).all()
    assert np.isin(np.asarray(ref.info.status), ok).all()
    x_ref = np.asarray(ref.x)
    assert np.abs(sol.x.numpy() - x_ref).max() <= 1e-3 * max(np.abs(x_ref).max(), 1)
    it_p, it_j = sol.info.iterations.numpy(), np.asarray(ref.info.iterations)
    if stack in ("split", "prox_headline"):
        np.testing.assert_array_equal(it_p, it_j)
    assert np.abs(it_p - it_j).max() <= ci, (it_p, it_j)


@pytest.mark.parametrize("stack", STACKS)
def test_f64_stack_solve_matches_jax(stack):
    """In float64 the precision knobs resolve to "highest" on both sides
    (JAX's f64 solve runs its XLA chunk; the port's plain versions round
    only float32): identical statuses and iterations, x and y within 1e-7."""
    sol, ref, _ = _solve_pair(stack, np.float64)
    np.testing.assert_array_equal(sol.info.status.numpy(), np.asarray(ref.info.status))
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    for name in ("x", "y"):
        a, b = getattr(sol, name).numpy(), np.asarray(getattr(ref, name))
        assert np.abs(a - b).max() <= 1e-7, (name, np.abs(a - b).max())


# ------------------------------------------------------------------- plans

@pytest.mark.parametrize("stack", STACKS)
def test_stack_plan_matches_jax(stack):
    """The port's plan names the variant the card runs (cache, lanes,
    dot_precision) as JAX's plan does at n = m = 128, where JAX's VMEM gate
    passes; at B = 5 the lanes fall back to 1 with JAX's reason, and
    require_fused turns that into an error."""
    for b in (B, 5):
        if stack == "prox_headline":
            arrs = [np.zeros((b,) + s, np.float32) for s in
                    ((N, N), (N,), (N, N), (N,), (N, N), (N,))]
            jpl = jax_plan.plan_proxqp(qps.make_proxqp(*arrs), PROX)
            prob = pt.make_proxqp(*arrs, device="cpu")
            ppl = pt.plan_proxqp(prob, _port(PROX))
            solve = lambda: pt.solve_proxqp(prob, _port(PROX))  # noqa: E731
        else:
            st = ADMM_STACKS[stack]
            arrs = [np.zeros((b,) + s, np.float32) for s in
                    ((N, N), (N,), (N, N), (N,), (N,))]
            jpl = jax_plan.plan(qps.make_qp(*arrs), st)
            qp = pt.make_qp(*arrs, device="cpu")
            ppl = pt.plan(qp, _port(st))
            solve = lambda: pt.solve(qp, _port(st))  # noqa: E731
        for f in ("chunk", "factor", "cache", "padded", "lanes",
                  "dot_precision", "fallback_reasons"):
            jv, pv = getattr(jpl, f), getattr(ppl, f)
            assert pv == NAMES.get(jv, jv), (f, pv, jv)
        assert (ppl.lanes > 1) == (b == B)
        if b != B:
            with pytest.raises(ValueError, match="does not divide"):
                solve()
