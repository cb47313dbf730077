"""Rows 3b, 9 and 10's redesigns as far as the CPU can hold them.

The bf16x3 slab level (``factor_precision="high"``) now runs one strip
launch a level on the tensor cores, and the rank-q and panel pivot sweeps
run in v3's register layout. Their previous kernels stay beside them as
bit-for-bit witnesses that no solver launches: ``slab_level_prev`` (now at
either precision) and ``pivot_sweep_group_prev``. On the CPU each witness
runs its successor's plain version: here they are held to the entry points'
CPU results and to the JAX package's kernel bodies, called eagerly through
a ref shim (``_slab_level_kernel`` at prec="high", ``_pivot_sweep_rq_kernel``,
``_pivot_sweep_panel_kernel``), at B = 4. The group dispatch rule
(``ops/spd_kernels.py: group_kernel``), the witnesses' refusals and
chip_smoke.py's bookkeeping of the new witness are checked too. The card
tests (tests/test_torch_cuda.py) hold the kernels themselves bit for bit.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraticprogramsolver_tpu.ops import spd_kernels as jax_spd
from quadraticprogramsolver_tpu.ops.fused_factor import (
    _slab_level_kernel as jax_slab_level_kernel)

from quadraticprogramsolver_tpu_torch.ops import fused_factor, spd_kernels

B, NB = 4, 128
ROOT = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


class _Ref:
    """A Pallas ref stand-in for calling a kernel body eagerly: reads index
    the array, writes replace it with ``.at[idx].set``."""

    def __init__(self, value):
        self.value = value

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, v):
        self.value = self.value.at[idx].set(v)


def _well(seed, b=B):
    """tests/test_spd_kernels.py's blocks: W'W + 128 I."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((b, NB, NB)).astype(np.float32)
    return (np.einsum("bki,bkj->bij", W, W) + NB * np.eye(NB, dtype=np.float32)
            ).astype(np.float32)


def _spread(seed, b=B):
    """SPD blocks with a spread of diagonal magnitudes (X X'/128 + I scaled
    by exp(U(-2, 2)) on each side), rounded to float32."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((b, NB, NB))
    D = X @ np.swapaxes(X, 1, 2) / NB + np.eye(NB)
    s = np.exp(rng.uniform(-2, 2, (b, NB)))
    return (D * s[:, :, None] * s[:, None, :]).astype(np.float32)


#: The group formulations and the JAX kernel body and keywords each copies.
BODIES = {
    "r2": (jax_spd._pivot_sweep_rq_kernel, dict(q=2)),
    "r4": (jax_spd._pivot_sweep_rq_kernel, dict(q=4)),
    "r8": (jax_spd._pivot_sweep_rq_kernel, dict(q=8)),
    "r16": (jax_spd._pivot_sweep_rq_kernel, dict(q=16)),
    "panel": (jax_spd._pivot_sweep_panel_kernel, {}),
}


def _jax_body(variant, D):
    """JAX's kernel body for ``variant`` on the (B, 128, 128) float32
    blocks, all B lanes in one call."""
    body, kw = BODIES[variant]
    b = D.shape[0]
    S = _Ref(jnp.asarray(D.reshape(b * NB, NB)))
    out = _Ref(jnp.zeros((b * NB, NB), jnp.float32))
    body(S, out, lanes=b, nb=NB, **kw)
    return np.asarray(out.value).reshape(b, NB, NB)


# ----------------------------------------------------------- the group rule

#: variant -> the kernel group_kernel names: v3's layout where a group's q
#: pivots lie in one warp's 16 rows, the first port where they span warps.
GROUP_RULE = {"r2": "warp", "r4": "warp", "r8": "warp", "r16": "warp",
              "panel": "warp", "r32": "block", "r64": "block",
              "r128": "block"}


@pytest.mark.parametrize("variant", list(GROUP_RULE))
def test_group_kernel_rule(variant):
    assert spd_kernels.group_kernel(variant) == GROUP_RULE[variant]


@pytest.mark.parametrize("variant", ["v3", "value", "ref", "r1", "r3", "bogus"])
def test_group_kernel_rule_refuses_other_variants(variant):
    """Only "r<q>" with q >= 2 dividing 128 and "panel" are group
    formulations; v3's arithmetic ("v3", "value", "r1") and "ref" have
    kernels of their own, other strings are no variant at all."""
    with pytest.raises(ValueError):
        spd_kernels.group_kernel(variant)


def test_the_main_path_knobs_run_the_new_group_kernel():
    """Every group formulation that chip_smoke.py's phase 9 runs (9c-9f)
    is one whose kernel is the redesign."""
    smoke = _chip_smoke()
    assert set(smoke.GROUP_VARIANTS) == {"r2", "r4", "r8", "panel"}
    assert {spd_kernels.group_kernel(v) for v in smoke.GROUP_VARIANTS} == {"warp"}
    knob_variants = {v for _, v, _ in smoke.FACTOR_KNOBS.values()}
    assert set(smoke.GROUP_VARIANTS) <= knob_variants


# --------------------------------------- the group witness against the JAX package

@pytest.mark.parametrize("kind", ["well", "spread"])
@pytest.mark.parametrize("variant", list(BODIES))
def test_group_witness_matches_jax_body_and_the_entry_point(variant, kind):
    """pivot_sweep_group_prev runs the formulation's plain version on the
    CPU: bit for bit spd_inverse_unrolled's CPU result, no launch counted,
    within 1e-5 of JAX's kernel body (both FP32 with the same operations;
    the Jacobi scale's rsqrt rounds differently) and within JAX's own limit
    of the f64 inverse (5e-6, tests/test_spd_kernels.py)."""
    D = _well(11) if kind == "well" else _spread(12)
    spd_kernels.pivot_sweep_group_prev.launches = 0
    out = spd_kernels.pivot_sweep_group_prev(_t(D), variant)
    assert spd_kernels.pivot_sweep_group_prev.launches == 0
    assert torch.equal(out, spd_kernels.spd_inverse_unrolled(_t(D), variant=variant))
    assert torch.equal(out, spd_kernels.pivot_sweep_plain(_t(D), variant))
    assert _rel(out, _jax_body(variant, D)) <= 1e-5
    assert _rel(out, np.linalg.inv(D.astype(np.float64))) <= 5e-6


@pytest.mark.parametrize("variant", ["r2", "panel"])
def test_group_witness_single_block_runs_the_sweep(variant):
    """At B = 1 the witness runs the sweep (no Cholesky rule: it stands for
    the kernel), as the JAX kernel body does."""
    D = _spread(13, b=1)
    out = spd_kernels.pivot_sweep_group_prev(_t(D), variant)
    assert torch.equal(out, spd_kernels.pivot_sweep_plain(_t(D), variant))
    assert _rel(out, _jax_body(variant, D)) <= 1e-5


def test_group_witness_f64():
    """In float64 the witness's plain version is the inverse to 1e-10."""
    D = _spread(14).astype(np.float64)
    for variant in ("r8", "panel"):
        out = spd_kernels.pivot_sweep_group_prev(_t(D), variant)
        assert out.dtype == torch.float64
        assert _rel(out, np.linalg.inv(D)) <= 1e-10


# ------------------------------------- the bf16x3 level witness against the JAX package

def _slab_case(seed, n=256, m=128):
    """tests/test_torch_factor_knobs.py's factor inputs at B = 4."""
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((B, n, n)).astype(np.float32) * 0.1
    P = np.einsum("bki,bkj->bij", Mm, Mm) + 0.1 * np.eye(n, dtype=np.float32)
    A = rng.standard_normal((B, m, n)).astype(np.float32) * 0.3
    q = rng.standard_normal((B, n)).astype(np.float32)
    rho = np.full((B, m), 0.4, np.float32)
    return tuple(_t(v.astype(np.float32)) for v in (P, A, q, rho))


@pytest.mark.parametrize("j", [0, 1])
def test_high_level_witness_matches_jax_body(j):
    """slab_level_prev(dot_precision="high") runs the bf16x3 plain version
    on the CPU: bit for bit slab_level(..., "high")'s CPU result, no launch
    counted, the pivot columns untouched; lane by lane within 1e-5 of JAX's
    level kernel body at prec="high"; and apart from the FP32 level by more
    than 1e-6 (a level that ignored the precision would be within FP32
    rounding, ~1e-7)."""
    P, A, q, rho = _slab_case(20 + j)
    S = fused_factor.build_slab(P, A, q, rho, 1e-6)
    kp = fused_factor.slab_k(A.shape[1])
    w_out = kp + j * NB
    Dinv = spd_kernels.spd_inverse_unrolled(
        S[:, j * NB:(j + 1) * NB, w_out:w_out + NB])
    Sw, Sh, Sf = S.clone(), S.clone(), S.clone()
    fused_factor.slab_level_prev.launches = 0
    fused_factor.slab_level_prev(Sw, Dinv, j, w_out, dot_precision="high")
    assert fused_factor.slab_level_prev.launches == 0
    fused_factor.slab_level(Sh, Dinv, j, w_out, dot_precision="high")
    fused_factor.slab_level_prev(Sf, Dinv, j, w_out)
    assert torch.equal(Sw, Sh)
    assert torch.equal(Sw[..., w_out:], S[..., w_out:])
    n = S.shape[1]
    for b in range(B):
        out = _Ref(jnp.zeros((1, n, w_out), jnp.float32))
        jax_slab_level_kernel(_Ref(jnp.asarray(S[b:b + 1, :, :w_out + NB].numpy())),
                              _Ref(jnp.asarray(Dinv[b:b + 1].numpy())), out,
                              n=n, j=j, w_out=w_out, prec="high")
        assert _rel(Sw[b, :, :w_out], out.value[0]) <= 1e-5
    assert _rel(Sw[..., :w_out], Sf[..., :w_out]) > 1e-6


def test_high_level_witness_f64_resolves_to_highest():
    """In float64 "high" resolves to "highest" in the witness as in the
    level: bit for bit the FP32-formula plain level."""
    P, A, q, rho = (t.double() for t in _slab_case(22))
    S = fused_factor.build_slab(P, A, q, rho, 1e-6)
    kp, j = fused_factor.slab_k(A.shape[1]), 1
    w_out = kp + j * NB
    Dinv = torch.linalg.inv(S[:, j * NB:, w_out:w_out + NB])
    Sh, Sp = S.clone(), S.clone()
    fused_factor.slab_level_prev(Sh, Dinv, j, w_out, dot_precision="high")
    fused_factor.slab_level_plain(Sp, Dinv, j, w_out)
    assert torch.equal(Sh, Sp)


# ------------------------------------------------------ what the witnesses refuse

def _level_call(dtype, device, prec="high"):
    S = torch.zeros((B, 256, 128 + 256), dtype=dtype, device=device)
    Dinv = torch.zeros((B, NB, NB), dtype=dtype, device=device)
    return fused_factor.slab_level_prev(S, Dinv, 1, 128, dot_precision=prec)


#: name -> a call of the witness on operands of the given dtype and device.
WITNESSES = {
    "pivot_sweep_group_prev": lambda dt, dev: spd_kernels.pivot_sweep_group_prev(
        torch.eye(NB, dtype=dt, device=dev).expand(B, NB, NB), "r4"),
    "slab_level_prev": _level_call,
}
OWNERS = {"pivot_sweep_group_prev": spd_kernels, "slab_level_prev": fused_factor}


@pytest.mark.parametrize("name", sorted(WITNESSES))
def test_witness_refuses_a_device_without_kernel(name):
    """A tensor on neither the CPU nor a CUDA card raises; nothing counts."""
    fn = getattr(OWNERS[name], name)
    fn.launches = 0
    with pytest.raises(ValueError, match="no kernel for device meta"):
        WITNESSES[name](torch.float32, "meta")
    assert fn.launches == 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("name", sorted(WITNESSES))
def test_witness_refuses_other_dtypes(name, dtype):
    """The witnesses take float32 (the kernels') or, on the CPU, float64
    (the plain versions'); other dtypes raise before any work."""
    with pytest.raises(ValueError, match="float32"):
        WITNESSES[name](dtype, "cpu")


@pytest.mark.parametrize("variant", ["v3", "ref", "value", "r1"])
def test_group_witness_refuses_other_formulations(variant):
    with pytest.raises(ValueError, match="not a group formulation"):
        spd_kernels.pivot_sweep_group_prev(torch.eye(NB).expand(B, NB, NB),
                                           variant)


def test_group_witness_refuses_other_shapes():
    with pytest.raises(ValueError, match="blocks must be"):
        spd_kernels.pivot_sweep_group_prev(torch.eye(64).expand(B, 64, 64), "r2")


@pytest.mark.parametrize("prec", ["default", "bf16"])
def test_levels_refuse_other_precisions(prec):
    """The level, its witness and the rule take "highest" and "high"."""
    with pytest.raises(ValueError, match="precision"):
        fused_factor.level_kernel(prec)
    with pytest.raises(ValueError, match="precision"):
        _level_call(torch.float32, "cpu", prec)
    S = torch.zeros((B, 256, 384))
    with pytest.raises(ValueError, match="precision"):
        fused_factor.slab_level(S, torch.zeros((B, NB, NB)), 1, 128, prec)


# ------------------------------------ chip_smoke.py reports the new witness

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault(spec.name, mod)
    spec.loader.exec_module(mod)
    return mod


def test_the_group_witness_has_a_kernels_json_entry():
    """pivot_sweep_group_prev has a kernels-JSON entry reporting phases
    9c-9f's witness launches, names the four formulations it witnesses, and
    is a counted witness wrapper (every counted run requires it at 0); the
    level's witness stays one too."""
    smoke = _chip_smoke()
    src, rep, tags = smoke.ENTRY_WITNESSES["pivot_sweep_group_prev"]
    assert (ROOT / "quadraticprogramsolver_tpu_torch" / src).is_file()
    assert rep == "quadraticprogramsolver_tpu/ops/spd_kernels.py:298"
    assert tags == ("9c", "9d", "9e", "9f")
    names = {f"pivot_sweep_{v}" for v in smoke.GROUP_VARIANTS}
    assert set(smoke.WITNESSES["pivot_sweep_group_prev"].split(", ")) == names
    assert names <= set(smoke.FACTOR_VARIANTS)
    counters = smoke.counters()
    for name in ("pivot_sweep_group_prev", "slab_level_prev"):
        assert name in smoke.WITNESS_WRAPPERS
        assert counters[name] is getattr(OWNERS[name], name)
