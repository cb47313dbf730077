"""The fused factor's two knobs in the port against the JAX package.

``Settings.pivot_variant`` picks the pivot sweep of the slab factor ("ref",
"value", "r<q>", "panel" beside "v3"), ``Settings.factor_precision="high"``
its bf16x3 level products. On the CPU the port runs each kernel's plain
version. JAX's rank-q kernel crashes XLA:CPU in interpret mode mid-suite and
its "ref" kernel takes ~30 s there (tests/test_spd_kernels.py), so the pivot
formulations are held against the JAX kernel bodies called eagerly through a
minimal ref shim; "value" and "v3" and the factor run in interpret mode.
Sizes: 128x128 pivot blocks, B = 8; solves at n = m = 128, B = 4.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.models import plan as jax_plan
from quadraticprogramsolver_tpu.ops import spd_kernels as jax_spd
from quadraticprogramsolver_tpu.ops.fused_factor import (
    _slab_level_kernel as jax_slab_level_kernel)
from quadraticprogramsolver_tpu.ops.fused_factor import (
    fused_factor_solve as jax_fused_factor_solve)

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.models import kkt as pt_kkt
from quadraticprogramsolver_tpu_torch.ops import fused_factor, spd_kernels
from quadraticprogramsolver_tpu_torch.utils.interop import qp_from_numpy

NB = 128
B_PIVOT = 8
#: The formulations with a kernel of their own, and the JAX kernel body and
#: keywords each copies.
BODIES = {
    "ref": (jax_spd._pivot_sweep_unrolled_kernel, {}),
    "r2": (jax_spd._pivot_sweep_rq_kernel, dict(q=2)),
    "r4": (jax_spd._pivot_sweep_rq_kernel, dict(q=4)),
    "r8": (jax_spd._pivot_sweep_rq_kernel, dict(q=8)),
    "r16": (jax_spd._pivot_sweep_rq_kernel, dict(q=16)),
    "panel": (jax_spd._pivot_sweep_panel_kernel, {}),
}


class _Ref:
    """A Pallas ref stand-in for calling a kernel body eagerly: reads index
    the array, writes replace it with ``.at[idx].set``."""

    def __init__(self, value):
        self.value = value

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, v):
        self.value = self.value.at[idx].set(v)


def _jax_body(variant, D):
    """JAX's kernel body for ``variant`` on the (B, 128, 128) float32 blocks,
    all B lanes in one call."""
    body, kw = BODIES[variant]
    B = D.shape[0]
    S = _Ref(jnp.asarray(D.reshape(B * NB, NB)))
    out = _Ref(jnp.zeros((B * NB, NB), jnp.float32))
    scratch = ([_Ref(jnp.zeros((B * NB, NB), jnp.float32))]
               if variant == "ref" else [])
    body(S, out, *scratch, lanes=B, nb=NB, **kw)
    return np.asarray(out.value).reshape(B, NB, NB)


def _well_blocks():
    """tests/test_spd_kernels.py's blocks: W'W + 128 I."""
    rng = np.random.default_rng(2)
    W = rng.standard_normal((B_PIVOT, NB, NB)).astype(np.float32)
    return (np.einsum("bki,bkj->bij", W, W)
            + NB * np.eye(NB, dtype=np.float32)).astype(np.float32)


def _spread_blocks(B=B_PIVOT, seed=0):
    """tests/test_torch_spd_kernels.py's blocks: a spread of diagonal
    magnitudes (exp(U(-2, 2)) on each side), the Jacobi scaling's case."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, NB, NB))
    D = X @ np.swapaxes(X, 1, 2) / NB + np.eye(NB)
    s = np.exp(rng.uniform(-2, 2, (B, NB)))
    return D * s[:, :, None] * s[:, None, :]


BLOCKS = {"well": _well_blocks, "spread": lambda: _spread_blocks().astype(np.float32)}


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


# ------------------------------------------------------- pivot formulations

@pytest.mark.parametrize("blocks", list(BLOCKS))
@pytest.mark.parametrize("variant", list(BODIES))
def test_pivot_formulation_matches_jax_body_and_f64(variant, blocks):
    """The plain formulation within 1e-5 of JAX's kernel body (both FP32
    with the same operations; the Jacobi scale's rsqrt rounds differently)
    and within JAX's own limits of the f64 inverse (tests/test_spd_kernels
    .py: 1e-5 for "ref", 5e-6 for the Jacobi-scaled ones)."""
    D = BLOCKS[blocks]()
    port = spd_kernels.spd_inverse_unrolled(torch.from_numpy(D), variant=variant)
    assert _rel(port, _jax_body(variant, D)) <= 1e-5
    exact = np.linalg.inv(D.astype(np.float64))
    assert _rel(port, exact) <= (1e-5 if variant == "ref" else 5e-6)


@pytest.mark.parametrize("q", [1, 2, 4, 8, 16, 32, 64, 128])
def test_every_rank_q_inverts(q):
    """Every q that divides 128 runs: float64 blocks to 1e-10 of the exact
    inverse; "r1" is v3's arithmetic (bit for bit the v3 plain version)."""
    D = torch.from_numpy(_spread_blocks(4, q))
    inv = spd_kernels.spd_inverse_unrolled(D, variant=f"r{q}")
    assert float((D @ inv - torch.eye(NB, dtype=D.dtype)).abs().max()) <= 1e-10
    if q == 1:
        assert torch.equal(inv, spd_kernels.pivot_sweep_v3_plain(D))


def test_value_is_v3_arithmetic():
    """JAX's "value" kernel agrees with its "v3" kernel (both in interpret
    mode: the same Jacobi scaling, folded fix and unscaling in another
    layout), and the port's "value" is its v3 sweep, bit for bit. (B = 4:
    "value" in interpret mode takes ~10 s at B = 4, ~20 s at B = 8.)"""
    D = _spread_blocks(4, 5).astype(np.float32)
    jv = np.asarray(jax_spd.pallas_spd_inverse_unrolled(D, variant="value",
                                                        interpret=True))
    j3 = np.asarray(jax_spd.pallas_spd_inverse_unrolled(D, variant="v3",
                                                        interpret=True))
    assert _rel(jv, j3) <= 1e-6
    Dt = torch.from_numpy(D)
    pv = spd_kernels.spd_inverse_unrolled(Dt, variant="value")
    assert torch.equal(pv, spd_kernels.spd_inverse_unrolled(Dt, variant="v3"))
    assert _rel(pv, jv) <= 1e-5


@pytest.mark.parametrize("variant", ["ref", "value", "r4", "panel"])
def test_small_batch_takes_cholesky_for_every_variant(variant):
    """The JAX package's size rule: a flat batch below 4 blocks is inverted
    by Cholesky whatever the variant."""
    D = torch.from_numpy(_spread_blocks(3, 7))
    np.testing.assert_allclose(
        spd_kernels.spd_inverse_unrolled(D, variant=variant).numpy(),
        np.linalg.inv(D.numpy()), rtol=1e-8, atol=1e-10)


def test_rank_q_validator_has_jax_message():
    """q must divide 128: the port's Settings and wrapper raise JAX's
    ValueError (JAX raises it at the kernel call)."""
    D = _well_blocks()[:4]
    with pytest.raises(ValueError) as e:
        jax_spd.pallas_spd_inverse_unrolled(D, variant="r3", interpret=True)
    with pytest.raises(ValueError, match=re.escape(str(e.value))):
        pt.Settings(pivot_variant="r3")
    with pytest.raises(ValueError, match=re.escape(str(e.value))):
        spd_kernels.spd_inverse_unrolled(torch.from_numpy(D), variant="r3")


def test_unknown_pivot_variant_raises():
    """Deliberate difference: JAX runs any unknown pivot_variant string as
    "ref"; the port names "ref" and raises on other strings, listing the
    variants."""
    assert qps.Settings(pivot_variant="bogus").pivot_variant == "bogus"
    with pytest.raises(ValueError, match="'v3', 'ref', 'value', 'panel'"):
        pt.Settings(pivot_variant="bogus")
    with pytest.raises(ValueError, match="r<q>"):
        spd_kernels.spd_inverse_unrolled(torch.eye(NB).expand(4, NB, NB),
                                         variant="bogus")


# ------------------------------------------------------ the bf16x3 level

def _slab_case(seed=0, B=4, n=256, m=128):
    """tests/test_fused_admm.py:337-343's factor inputs, at B = 4 (with
    B < 4 both packages invert the pivots by Cholesky)."""
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((B, n, n)).astype(np.float32) * 0.1
    P = np.einsum("bki,bkj->bij", Mm, Mm) + 0.1 * np.eye(n, dtype=np.float32)
    A = rng.standard_normal((B, m, n)).astype(np.float32) * 0.3
    q = rng.standard_normal((B, n)).astype(np.float32)
    rho = np.full((B, m), 0.4, np.float32)
    return P.astype(np.float32), A, q, rho


def test_slab_level_high_matches_jax_body():
    """One bf16x3 level (the last pivot block, j = 1 at n = 256) against
    JAX's level kernel body at prec="high", lane by lane: within 1e-5 of the
    level's max; and apart from the port's FP32 level by more than 1e-6 of
    it (the bf16x3 rounding: a level that ignored the precision would be
    within FP32 rounding, ~1e-7)."""
    P, A, q, rho = (torch.from_numpy(v) for v in _slab_case())
    S = fused_factor.build_slab(P, A, q, rho, 1e-6)
    kp, j = fused_factor.slab_k(A.shape[1]), 1
    w_out = kp + j * NB
    Dinv = spd_kernels.spd_inverse_unrolled(
        S[:, j * NB:(j + 1) * NB, w_out:w_out + NB])
    Sh, Sf = S.clone(), S.clone()
    fused_factor.slab_level(Sh, Dinv, j, w_out, dot_precision="high")
    fused_factor.slab_level(Sf, Dinv, j, w_out)
    n = S.shape[1]
    for b in range(S.shape[0]):
        out = _Ref(jnp.zeros((1, n, w_out), jnp.float32))
        jax_slab_level_kernel(_Ref(jnp.asarray(S[b:b + 1, :, :w_out + NB].numpy())),
                              _Ref(jnp.asarray(Dinv[b:b + 1].numpy())), out,
                              n=n, j=j, w_out=w_out, prec="high")
        assert _rel(Sh[b, :, :w_out], out.value[0]) <= 1e-5
    assert torch.equal(Sh[..., w_out:], S[..., w_out:])
    assert _rel(Sh[..., :w_out], Sf[..., :w_out]) > 1e-6


def test_fused_factor_high_matches_jax_interpret():
    """fused_factor_solve(dot_precision="high") against JAX's in interpret
    mode. The bf16x3 levels put 2-3e-5 of G's max between either side and
    the f64 factor (2.2-2.9e-5 for JAX, 1.9-3.0e-5 for the port over three
    seeds), and the two sides round their bf16 splits apart, so they differ
    by 1.0-3.0e-5, past the FP32 limit of 1e-5. So the f64 witness of the
    FP32 M^{-1} chunks holds the factor: per output (G, g), the port's error
    against the f64 factor within 3x JAX's, plus 1e-7 of the output; and
    within JAX's own "high" against "highest" limit (1e-4,
    tests/test_fused_admm.py), while apart from the port's FP32 factor by
    more than 1e-6. In float64 "high" resolves to "highest" bit for bit."""
    P, A, q, rho = _slab_case(1)
    m = A.shape[1]
    S_j = np.asarray(jax_fused_factor_solve(P, A, q, rho, sigma=1e-6,
                                            dot_precision="high", interpret=True))
    args = [torch.from_numpy(v) for v in (P, A, q, rho)]
    S_p = fused_factor.fused_factor_solve(*args, sigma=1e-6, dot_precision="high")
    S_f = fused_factor.fused_factor_solve(*args, sigma=1e-6)
    f64 = [a.double() for a in args]
    S_w = fused_factor.fused_factor_solve(*f64, sigma=1e-6, dot_precision="high")
    assert torch.equal(S_w, fused_factor.fused_factor_solve(*f64, sigma=1e-6))
    for cols in (slice(0, m), m):
        port, jax_, wit = S_p[..., cols].numpy(), S_j[..., cols], S_w[..., cols].numpy()
        scale = np.abs(wit).max()
        assert (np.abs(port - wit).max()
                <= 3.0 * np.abs(jax_ - wit).max() + 1e-7 * scale)
        assert _rel(port, jax_) <= 1e-4
        assert _rel(port, S_f[..., cols]) > 1e-6


# -------------------------------------------------------------- settings

_SLAB = dict(fused_factor=True, sigma_free_rhs=True, kkt_refinement_steps=0)


def test_factor_precision_on_and_off_the_slab():
    """factor_precision "high"/"default" run on the slab factor and off it:
    Settings takes them with or without the slab's knobs, and off the
    slab's shapes (m = 100, no fused_chunk to pad it: the unfused
    sigma-free route) cholesky_init runs the factor's products at that
    precision, as JAX's XLA factor does: bit for bit the factor under
    matmul_precision at the same level (factor_precision inherits it), and
    apart from the FP32 factor. Other strings raise ValueError."""
    for prec in ("high", "default"):
        assert pt.Settings(factor_precision=prec, **_SLAB).factor_precision == prec
        assert pt.Settings(factor_precision=prec).factor_precision == prec
        assert pt.Settings(factor_precision=prec, sigma_free_rhs=True,
                           kkt_refinement_steps=0).factor_precision == prec
    with pytest.raises(ValueError, match="factor_precision"):
        pt.Settings(factor_precision="bf16", **_SLAB)
    rng = np.random.default_rng(0)
    P = np.eye(NB)[None].repeat(4, 0)
    A = rng.standard_normal((4, 100, NB))
    qp = qp_from_numpy(P, np.zeros((4, NB)), A, -np.ones((4, 100)),
                       np.ones((4, 100)), device="cpu", dtype=torch.float32)
    rho = torch.full((4,), 0.1)
    full = pt_kkt.cholesky_init(qp, rho, 1e-6, pt.Settings(**_SLAB))["G"]
    for prec in ("high", "default"):
        G = pt_kkt.cholesky_init(qp, rho, 1e-6, pt.Settings(
            factor_precision=prec, **_SLAB))["G"]
        inherited = pt_kkt.cholesky_init(qp, rho, 1e-6, pt.Settings(
            matmul_precision=prec, **_SLAB))["G"]
        assert torch.equal(G, inherited), prec
        assert float((G - full).abs().max()) > 1e-7, prec


# ----------------------------------------------------------------- solves

B, N = 4, 128
#: Phase 3's knobs (chip_smoke.py) on a small fleet, and each factor knob.
BASE = qps.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4, rho=0.4,
                    check_interval=11, kkt_refinement_steps=0,
                    sigma_free_rhs=True, fused_factor=True, fused_chunk=True,
                    adaptive_rho=False, require_fused=True)
KNOBS = {**{v: dict(pivot_variant=v) for v in
            ("ref", "value", "r2", "r4", "r8", "panel")},
         "high": dict(factor_precision="high")}


def _fleet(dtype):
    return qps.pad_qp(qps.generate_batch(qps.ProblemClass.RANDOM_QP, batch=B,
                                         num_elements=100, seed=0,
                                         dtype=dtype), N, N)


def _port_qp(qp_j, dtype):
    return qp_from_numpy(*(np.asarray(getattr(qp_j, k)) for k in "PqAlu"),
                         device="cpu", dtype=getattr(torch, np.dtype(dtype).name))


def _port_settings(st):
    return pt.Settings(**{k: v for k, v in dataclasses.asdict(st).items()
                          if k != "kkt_backend"})


@pytest.fixture(scope="module")
def jax_f32_v3():
    """JAX's f32 fused solve with the v3 pivots and the FP32 level
    (interpret mode), shared by every f32 case."""
    return qps.solve_jit(_fleet(np.float32), BASE)


@pytest.fixture(scope="module")
def jax_f64():
    """JAX's f64 solves (its XLA route: the fused factor is f32-only), one
    per knob."""
    qp = _fleet(np.float64)
    st = dataclasses.replace(BASE, require_fused=False)
    return {k: qps.solve_jit(qp, dataclasses.replace(st, **kw))
            for k, kw in KNOBS.items()}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_f64_solve_matches_jax(knob, jax_f64):
    """In float64 the port runs the slab factor's plain versions with the
    named formulation ("high" resolves to "highest"): identical statuses and
    iterations to JAX's f64 solve, x and y within 1e-7."""
    st = _port_settings(dataclasses.replace(BASE, **KNOBS[knob]))
    sol = pt.solve(_port_qp(_fleet(np.float64), np.float64), st)
    ref = jax_f64[knob]
    np.testing.assert_array_equal(sol.info.status.numpy(), np.asarray(ref.info.status))
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    for name in ("x", "y"):
        a, b = getattr(sol, name).numpy(), np.asarray(getattr(ref, name))
        assert np.abs(a - b).max() <= 1e-7, (name, np.abs(a - b).max())


@pytest.mark.parametrize("knob", list(KNOBS))
def test_f32_solve_matches_jax_v3(knob, jax_f32_v3):
    """The port's f32 solve with each knob against JAX's f32 fused v3 solve:
    the same statuses, x within 1e-3 * max(|x|, 1), iterations equal or one
    check apart."""
    st = _port_settings(dataclasses.replace(BASE, **KNOBS[knob]))
    sol = pt.solve(_port_qp(_fleet(np.float32), np.float32), st)
    ref = jax_f32_v3
    np.testing.assert_array_equal(sol.info.status.numpy(), np.asarray(ref.info.status))
    x_ref = np.asarray(ref.x)
    assert np.abs(sol.x.numpy() - x_ref).max() <= 1e-3 * max(np.abs(x_ref).max(), 1)
    d = np.abs(sol.info.iterations.numpy() - np.asarray(ref.info.iterations))
    assert d.max() <= BASE.check_interval, d


@pytest.mark.parametrize("knob", list(KNOBS))
def test_plan_matches_jax(knob):
    """The knobs add no plan field in either package: the same plan, the
    slab factor, no fallback."""
    st = dataclasses.replace(BASE, **KNOBS[knob])
    arrs = [np.zeros((B,) + s, np.float32) for s in
            ((N, N), (N,), (N, N), (N,), (N,))]
    jpl = jax_plan.plan(qps.make_qp(*arrs), st)
    ppl = pt.plan(pt.make_qp(*arrs, device="cpu"), _port_settings(st))
    assert (ppl.factor, ppl.cache, ppl.fallback_reasons) == (
        "fused_slab", jpl.cache, jpl.fallback_reasons)
