"""The kept first kernels of rows 6, 7, 11 and 12 as far as the CPU can hold
them.

The round-1 sweep (``spd_inverse_nb``), the "ref" pivot sweep, the paired-64
sweep (``spd_inverse_64p``) and the fused normal inverse each run a
redesigned kernel on the card; their first kernels stay beside them as
bit-for-bit witnesses that no entry point launches (``pivot_sweep_2d_prev``,
``pivot_sweep_ref_prev``, ``pivot_sweep_v3p_prev``, ``normal_inverse_prev``
in ``ops/spd_kernels.py``). On the CPU each witness wrapper runs its
successor's plain version: here they are held bit for bit to the entry
points' CPU results and to the JAX package (``pallas_spd_inverse_nb``,
``pallas_spd_inverse_64p`` and ``pallas_normal_inverse`` in interpret mode,
the "ref" kernel body called eagerly through a ref shim, since its interpret
mode takes ~30 s), at B = 4 and n = 256 (64 for the paired sweep); they
refuse devices without a kernel and dtypes and shapes the kernels do not
take; and chip_smoke.py requires every ``*_prev`` wrapper of the port at
zero launches in every counted run. The card tests (tests/test_torch_cuda.py)
hold the kernels themselves bit for bit.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraticprogramsolver_tpu.ops import spd_kernels as jax_spd

from quadraticprogramsolver_tpu_torch.ops import fused_factor, spd_kernels, spmv

B, NB = 4, 128
ROOT = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _well(seed, b=B, nb=NB):
    """tests/test_spd_kernels.py's blocks: W'W + nb I."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((b, nb, nb)).astype(np.float32)
    return (np.einsum("bki,bkj->bij", W, W) + nb * np.eye(nb, dtype=np.float32)
            ).astype(np.float32)


def _spread(seed, b=B, nb=NB):
    """SPD blocks with a spread of diagonal magnitudes (X X'/nb + I scaled
    by exp(U(-2, 2)) on each side), rounded to float32."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((b, nb, nb))
    D = X @ np.swapaxes(X, 1, 2) / nb + np.eye(nb)
    s = np.exp(rng.uniform(-2, 2, (b, nb)))
    return (D * s[:, :, None] * s[:, None, :]).astype(np.float32)


def _normal(seed, b=B, n=256, m=128):
    """P = W W'/n + 0.1 I, A = 0.1 N(0, 1), per-lane rho in [0.1, 10]."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((b, n, n)).astype(np.float32)
    P = (np.einsum("bij,bkj->bik", W, W) / n + 0.1 * np.eye(n)).astype(np.float32)
    A = (0.1 * rng.standard_normal((b, m, n))).astype(np.float32)
    rho = np.logspace(-1, 1, b).astype(np.float32)
    return P, A, rho


class _Ref:
    """A Pallas ref stand-in for calling a kernel body eagerly: reads index
    the array, writes replace it with ``.at[idx].set``."""

    def __init__(self, value):
        self.value = value

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, v):
        self.value = self.value.at[idx].set(v)


def _jax_ref_sweep(D):
    """JAX's "ref" kernel body (_pivot_sweep_unrolled_kernel) on the (B,
    128, 128) float32 blocks, all B lanes in one call."""
    b = D.shape[0]
    S = _Ref(jnp.asarray(D.reshape(b * NB, NB)))
    out = _Ref(jnp.zeros((b * NB, NB), jnp.float32))
    scratch = _Ref(jnp.zeros((b * NB, NB), jnp.float32))
    jax_spd._pivot_sweep_unrolled_kernel(S, out, scratch, lanes=b, nb=NB)
    return np.asarray(out.value).reshape(b, NB, NB)


# ------------------------------------------- the witnesses against the JAX package

@pytest.mark.parametrize("kind", ["well", "spread"])
def test_round1_witness_matches_jax_and_the_entry_point(kind):
    """pivot_sweep_2d_prev runs the round-1 sweep's plain version on the
    CPU: bit for bit spd_inverse_nb's CPU result, within 1e-5 of JAX's
    kernel in interpret mode (both FP32, the same operations)."""
    D = _well(1) if kind == "well" else _spread(2)
    spd_kernels.pivot_sweep_2d_prev.launches = 0
    out = spd_kernels.pivot_sweep_2d_prev(_t(D))
    assert spd_kernels.pivot_sweep_2d_prev.launches == 0
    assert torch.equal(out, spd_kernels.spd_inverse_nb(_t(D)))
    assert torch.equal(out, spd_kernels.sweep_inverse_block_plain(_t(D), guard_zero=True))
    ref = np.asarray(jax_spd.pallas_spd_inverse_nb(jnp.asarray(D), lanes=2,
                                                   interpret=True))
    assert _rel(out, ref) <= 1e-5


def test_round1_witness_zero_pivot():
    """A zero pivot reads as 1 in the witness as in JAX's kernel."""
    D = _well(3)
    D[:, 7, :] = 0.0
    D[:, :, 7] = 0.0
    out = spd_kernels.pivot_sweep_2d_prev(_t(D)).numpy()
    ref = np.asarray(jax_spd.pallas_spd_inverse_nb(jnp.asarray(D), interpret=True))
    assert np.isfinite(out).all() and (out[:, 7, 7] == 1.0).all()
    assert _rel(out, ref) <= 1e-5


@pytest.mark.parametrize("kind", ["well", "spread"])
def test_ref_witness_matches_jax_and_the_entry_point(kind):
    """pivot_sweep_ref_prev runs the "ref" plain version on the CPU: bit for
    bit the "ref" formulation's CPU result, within 1e-5 of JAX's kernel
    body on well-conditioned blocks; on spread-diagonal blocks, where FP32
    rounding of the unscaled sweep fills 1e-5, both within 3x of each
    other's error against the f64 inverse."""
    D = _well(4) if kind == "well" else _spread(5)
    out = spd_kernels.pivot_sweep_ref_prev(_t(D))
    assert torch.equal(out, spd_kernels.spd_inverse_unrolled(_t(D), variant="ref"))
    assert torch.equal(out, spd_kernels.pivot_sweep_ref_plain(_t(D)))
    ref = _jax_ref_sweep(D)
    if kind == "well":
        assert _rel(out, ref) <= 1e-5
    else:
        exact = np.linalg.inv(D.astype(np.float64))
        ep, ej = _rel(out, exact), _rel(ref, exact)
        assert ep <= 3 * ej and ej <= 3 * ep, (ep, ej)


def test_ref_witness_single_block_runs_the_sweep():
    """At B = 1 the witness runs the sweep (no Cholesky rule: it stands for
    the kernel), as the JAX kernel body does."""
    D = _well(6, b=1)
    out = spd_kernels.pivot_sweep_ref_prev(_t(D))
    assert out.shape == (1, NB, NB)
    assert torch.equal(out, spd_kernels.pivot_sweep_ref_plain(_t(D)))
    assert _rel(out, _jax_ref_sweep(D)) <= 1e-5


@pytest.mark.parametrize("kind", ["well", "spread"])
def test_paired_witness_matches_jax_and_the_entry_point(kind):
    """pivot_sweep_v3p_prev runs the paired sweep's plain version on the
    CPU: bit for bit spd_inverse_64p's CPU result, within 1e-5 of JAX's
    pallas_spd_inverse_64p in interpret mode (lanes 2; both FP32, the same
    operations)."""
    D = _well(11, nb=64) if kind == "well" else _spread(12, nb=64)
    spd_kernels.pivot_sweep_v3p_prev.launches = 0
    out = spd_kernels.pivot_sweep_v3p_prev(_t(D))
    assert spd_kernels.pivot_sweep_v3p_prev.launches == 0
    assert torch.equal(out, spd_kernels.spd_inverse_64p(_t(D)))
    assert torch.equal(out, spd_kernels.pivot_sweep_v3p_plain(_t(D)))
    ref = np.asarray(jax_spd.pallas_spd_inverse_64p(jnp.asarray(D), lanes=2,
                                                    interpret=True))
    assert _rel(out, ref) <= 1e-5


def test_paired_witness_takes_any_batch():
    """The witness stands for the kernel, which takes any B >= 1: no even-B
    or two-pair rule, unlike spd_inverse_64p."""
    D = _well(13, b=3, nb=64)
    out = spd_kernels.pivot_sweep_v3p_prev(_t(D))
    assert out.shape == (3, 64, 64)
    assert torch.equal(out, spd_kernels.pivot_sweep_v3p_plain(_t(D)))
    with pytest.raises(ValueError, match="even"):
        spd_kernels.spd_inverse_64p(_t(D))


@pytest.fixture(scope="module")
def normal_case():
    """B = 4, n = 256, m = 128 with per-lane rho, and JAX's kernel on it in
    interpret mode."""
    P, A, rho = _normal(7)
    ref = np.asarray(jax_spd.pallas_normal_inverse(
        jnp.asarray(P), jnp.asarray(A), jnp.asarray(rho), sigma=1e-6,
        interpret=True))
    return (P, A, rho), ref


def test_normal_witness_matches_jax_and_the_entry_point(normal_case):
    """normal_inverse_prev runs normal_inverse_plain on the CPU: bit for bit
    normal_inverse's CPU result, within 1e-5 of JAX's kernel and with JAX's
    own limits against the f64 inverse (residual 5e-5, relative 1e-5)."""
    (P, A, rho), ref = normal_case
    spd_kernels.normal_inverse_prev.launches = 0
    out = spd_kernels.normal_inverse_prev(_t(P), _t(A), _t(rho), sigma=1e-6)
    assert spd_kernels.normal_inverse_prev.launches == 0
    assert torch.equal(out, spd_kernels.normal_inverse(_t(P), _t(A), _t(rho),
                                                       sigma=1e-6))
    assert _rel(out, ref) <= 1e-5
    n = P.shape[-1]
    M = (P.astype(np.float64) + 1e-6 * np.eye(n) + rho[:, None, None].astype(
        np.float64) * np.einsum("bki,bkj->bij", A, A, dtype=np.float64))
    resid = np.abs(np.einsum("bij,bjk->bik", out.numpy().astype(np.float64), M)
                   - np.eye(n)).max()
    assert resid <= 5e-5, resid
    assert _rel(out, np.linalg.inv(M)) <= 1e-5


def test_normal_witness_f64():
    """In float64 the witness wrapper's plain version is the inverse of (P +
    sigma I) + rho A'A to 1e-10."""
    P, A, rho = (a.astype(np.float64) for a in _normal(8, b=2, n=128))
    out = spd_kernels.normal_inverse_prev(_t(P), _t(A), _t(rho), sigma=1e-6)
    M = P + 1e-6 * np.eye(128) + rho[:, None, None] * np.einsum("bki,bkj->bij", A, A)
    assert out.dtype == torch.float64
    assert _rel(out, np.linalg.inv(M)) <= 1e-10


# -------------------------------------------------- what the witnesses refuse

#: name -> a call of the witness on (B, 128, 128) operands (the paired
#: sweep's: (B, 64, 64)) of the given dtype and device.
WITNESSES = {
    "pivot_sweep_2d_prev": lambda dt, dev: spd_kernels.pivot_sweep_2d_prev(
        torch.eye(NB, dtype=dt, device=dev).expand(B, NB, NB)),
    "pivot_sweep_ref_prev": lambda dt, dev: spd_kernels.pivot_sweep_ref_prev(
        torch.eye(NB, dtype=dt, device=dev).expand(B, NB, NB)),
    "pivot_sweep_v3p_prev": lambda dt, dev: spd_kernels.pivot_sweep_v3p_prev(
        torch.eye(64, dtype=dt, device=dev).expand(B, 64, 64)),
    "normal_inverse_prev": lambda dt, dev: spd_kernels.normal_inverse_prev(
        torch.eye(NB, dtype=dt, device=dev).expand(B, NB, NB),
        torch.zeros((B, NB, NB), dtype=dt, device=dev),
        torch.ones(B, dtype=dt, device=dev), sigma=0.0),
}


@pytest.mark.parametrize("name", sorted(WITNESSES))
def test_witness_refuses_a_device_without_kernel(name):
    """A tensor on neither the CPU nor a CUDA card raises; nothing counts."""
    fn = getattr(spd_kernels, name)
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


@pytest.mark.parametrize("name", ["pivot_sweep_2d_prev", "pivot_sweep_ref_prev"])
def test_sweep_witness_refuses_other_shapes(name):
    with pytest.raises(ValueError, match="blocks must be"):
        getattr(spd_kernels, name)(torch.eye(64).expand(B, 64, 64))


@pytest.mark.parametrize("shape", [(B, NB, NB), (B, 64, 32), (64, 64)])
def test_paired_witness_refuses_other_shapes(shape):
    with pytest.raises(ValueError, match="blocks must be"):
        spd_kernels.pivot_sweep_v3p_prev(torch.ones(shape))


def test_normal_witness_checks_shapes():
    P, A, rho = (_t(a) for a in _normal(9, b=2, n=128))
    with pytest.raises(ValueError, match="multiples of 128"):
        spd_kernels.normal_inverse_prev(P[:, :100, :100], A[:, :, :100], rho,
                                        sigma=0.0)
    with pytest.raises(ValueError, match=r"rho \(B,\)"):
        spd_kernels.normal_inverse_prev(P, A, rho[:1], sigma=0.0)


# ------------------------------------ chip_smoke.py requires them at 0 launches

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault(spec.name, mod)
    spec.loader.exec_module(mod)
    return mod


def _prev_wrappers(module):
    return sorted(name for name in vars(module)
                  if name.endswith("_prev") and callable(getattr(module, name))
                  and hasattr(getattr(module, name), "launches"))


@pytest.mark.parametrize("module", [spd_kernels, fused_factor, spmv],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_every_prev_wrapper_is_a_chip_smoke_witness(module):
    """Every counted ``*_prev`` wrapper of the port (the modules that keep
    previous kernels) is read by one of chip_smoke.py's WITNESS_WRAPPERS
    counters, whose counts every counted run requires at 0."""
    smoke = _chip_smoke()
    counters = smoke.counters()
    watched = [counters[k] for k in smoke.WITNESS_WRAPPERS]
    names = _prev_wrappers(module)
    assert names
    for name in names:
        assert any(fn is getattr(module, name) for fn in watched), name


def test_no_ops_module_keeps_an_unwatched_prev_wrapper():
    """No module of the port's ops package has a counted ``*_prev``
    wrapper that chip_smoke.py does not watch."""
    import importlib
    import pkgutil

    from quadraticprogramsolver_tpu_torch import ops

    smoke = _chip_smoke()
    counters = smoke.counters()
    watched = [counters[k] for k in smoke.WITNESS_WRAPPERS]
    for info in pkgutil.iter_modules(ops.__path__):
        module = importlib.import_module(f"{ops.__name__}.{info.name}")
        for name in _prev_wrappers(module):
            assert any(fn is getattr(module, name) for fn in watched), (
                info.name, name)


def test_the_new_witnesses_have_kernels_json_entries():
    """Rows 6, 7, 11 and 12's witnesses have a kernels-JSON entry each,
    beside their successors (WITNESSES maps each to it), and the four are
    counted witness wrappers."""
    smoke = _chip_smoke()
    new = {"pivot_sweep_2d_prev": "pivot_sweep_2d",
           "pivot_sweep_ref_prev": "pivot_sweep_ref",
           "pivot_sweep_v3p_prev": "pivot_sweep_v3p",
           "normal_inverse_prev": "normal_inverse"}
    assert set(new) <= set(smoke.ENTRY_WITNESSES)
    assert {k: smoke.WITNESSES[k] for k in new} == new
    assert set(new) <= set(smoke.WITNESS_WRAPPERS)
    for name, (src, rep, _) in smoke.ENTRY_WITNESSES.items():
        assert (ROOT / "quadraticprogramsolver_tpu_torch" / src).is_file(), src
        assert rep.startswith("quadraticprogramsolver_tpu/ops/spd_kernels.py:")
