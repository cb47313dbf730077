"""The package's other SPD-inverse entry points in the port against the JAX
package, and the FP32 scope of every solve.

Rows 6, 11 and 12 of the kernel table: ``spd_inverse_nb`` (the round-1
unscaled sweep with its zero-pivot guard) and the flat ``spd_inverse_sweep``
around it, ``spd_inverse_64p`` (the paired-64 sweep) and the block Schur
``spd_inverse_128_schur`` built on it, and ``normal_inverse`` (M = P + sigma
I + rho A'A and its inverse per lane). On the CPU the port runs each
kernel's plain version; JAX runs its kernels in interpret mode, once per
input (module fixtures). Sizes: B = 4 blocks, n = 256 sweeps, JAX's own
normal-inverse inputs (tests/test_spd_kernels.py).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraticprogramsolver_tpu.ops import spd_kernels as jax_spd

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.models import proxqp as pt_proxqp
from quadraticprogramsolver_tpu_torch.ops import linalg, spd_kernels
from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
    device_random_qp_fleet)
from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
    device_prox_fleet)

B = 4
LANES = 2


def _well(B, nb, seed):
    """tests/test_spd_kernels.py's blocks: W'W + nb I."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((B, nb, nb)).astype(np.float32)
    return (np.einsum("bki,bkj->bij", W, W)
            + nb * np.eye(nb, dtype=np.float32)).astype(np.float32)


def _spread(B, nb, seed):
    """SPD blocks with a spread of diagonal magnitudes (X X'/nb + I scaled by
    exp(U(-2, 2)) on each side), in float64."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, nb, nb))
    D = X @ np.swapaxes(X, 1, 2) / nb + np.eye(nb)
    s = np.exp(rng.uniform(-2, 2, (B, nb)))
    return D * s[:, :, None] * s[:, None, :]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def blocks128():
    """Four well-conditioned 128-blocks and JAX's round-1 sweep and Schur
    inverse of them (interpret mode, lanes 2)."""
    D = _well(B, 128, 2)
    return D, {
        "nb": np.asarray(jax_spd.pallas_spd_inverse_nb(
            jnp.asarray(D), lanes=LANES, interpret=True)),
        "schur": np.asarray(jax_spd.spd_inverse_128_schur(
            jnp.asarray(D), lanes=LANES, interpret=True)),
    }


@pytest.fixture(scope="module")
def blocks64():
    D = _well(B, 64, 3)
    return D, np.asarray(jax_spd.pallas_spd_inverse_64p(
        jnp.asarray(D), lanes=LANES, interpret=True))


# ------------------------------------------------- row 6: the round-1 sweep

def test_round1_sweep_matches_jax(blocks128):
    """The plain round-1 sweep within 1e-5 of JAX's kernel (both FP32 with
    the same operations; JAX's one-hot dots add zeros)."""
    D, ref = blocks128
    assert _rel(spd_kernels.spd_inverse_nb(_t(D), lanes=LANES), ref["nb"]) <= 1e-5


@pytest.mark.parametrize("kind", ["well", "spread"])
def test_round1_sweep_f64(kind):
    """In float64 the unscaled sweep (guarded or not) is the inverse to
    1e-10, on well-conditioned and on spread-diagonal blocks."""
    D = _well(B, 128, 5).astype(np.float64) if kind == "well" else _spread(B, 128, 5)
    exact = np.linalg.inv(D)
    assert _rel(spd_kernels.spd_inverse_nb(_t(D)), exact) <= 1e-10
    assert _rel(spd_kernels.sweep_inverse_block_plain(_t(D)), exact) <= 1e-10


def test_round1_sweep_single_block():
    """B = 1 runs the sweep (no Cholesky rule, as in the JAX wrapper) and
    matches JAX's kernel at B = 1."""
    D = _well(1, 128, 6)
    ref = np.asarray(jax_spd.pallas_spd_inverse_nb(jnp.asarray(D), interpret=True))
    out = spd_kernels.spd_inverse_nb(_t(D))
    assert out.shape == (1, 128, 128)
    assert _rel(out, ref) <= 1e-5


def test_round1_sweep_zero_pivot_guard():
    """A block whose row and column 5 are zero meets a zero pivot at step 5:
    the guard reads it as 1, as JAX's kernel does (finite, (5, 5) = 1, the
    rest the inverse of the other rows and columns); the unguarded block
    sweep, as JAX's _sweep_inverse_block, divides by zero."""
    D = _well(2, 128, 7)
    D[:, 5, :] = 0.0
    D[:, :, 5] = 0.0
    ref = np.asarray(jax_spd.pallas_spd_inverse_nb(jnp.asarray(D), interpret=True))
    out = spd_kernels.spd_inverse_nb(_t(D)).numpy()
    assert np.isfinite(ref).all() and np.isfinite(out).all()
    assert _rel(out, ref) <= 1e-5
    assert (out[:, 5, 5] == 1.0).all()
    keep = np.delete(np.arange(128), 5)
    rest = np.linalg.inv(D[:, keep][:, :, keep].astype(np.float64))
    assert _rel(out[:, keep][:, :, keep], rest) <= 1e-5
    assert not torch.isfinite(spd_kernels.sweep_inverse_block_plain(_t(D))).all()


def test_flat_sweep_matches_jax():
    """spd_inverse_sweep at n = 256 (two levels around the round-1 sweep)
    within 1e-5 of JAX's, and of the f64 inverse."""
    M = _well(2, 256, 4)
    ref = np.asarray(jax_spd.spd_inverse_sweep(
        jnp.asarray(M), pivot_inverse=lambda d: jax_spd.pallas_spd_inverse_nb(
            d, lanes=LANES, interpret=True)))
    out = spd_kernels.spd_inverse_sweep(_t(M))
    assert _rel(out, ref) <= 1e-5
    assert _rel(out, np.linalg.inv(M.astype(np.float64))) <= 1e-5
    Md = _spread(2, 256, 8)
    assert _rel(spd_kernels.spd_inverse_sweep(_t(Md)), np.linalg.inv(Md)) <= 1e-10


# -------------------------------------- row 11: the paired-64 sweep, Schur

def test_paired_sweep_matches_jax(blocks64):
    D, ref = blocks64
    out = spd_kernels.spd_inverse_64p(_t(D), lanes=LANES)
    assert _rel(out, ref) <= 1e-5
    assert _rel(spd_kernels.pivot_sweep_v3p_plain(_t(D)), ref) <= 1e-5


@pytest.mark.parametrize("kind", ["well", "spread"])
def test_paired_sweep_f64(kind):
    D = _well(B, 64, 9).astype(np.float64) if kind == "well" else _spread(B, 64, 9)
    assert _rel(spd_kernels.spd_inverse_64p(_t(D)), np.linalg.inv(D)) <= 1e-10


def test_paired_sweep_divides_by_the_pivot():
    """The paired sweep divides its pivot column by the pivot (JAX
    :440-441), where v3 multiplies by its reciprocal: the same f32 blocks
    give other bits than the v3 arithmetic, and both stay within 1e-5."""
    D = _t(_spread(B, 64, 10).astype(np.float32))
    v3p = spd_kernels.pivot_sweep_v3p_plain(D)
    v3 = spd_kernels.pivot_sweep_v3_plain(D)
    assert not torch.equal(v3p, v3)
    assert _rel(v3p, v3) <= 1e-5


def test_schur_matches_jax(blocks128):
    D, ref = blocks128
    out = spd_kernels.spd_inverse_128_schur(_t(D), lanes=LANES)
    assert _rel(out, ref["schur"]) <= 1e-5
    assert _rel(out, np.linalg.inv(D.astype(np.float64))) <= 1e-5


@pytest.mark.parametrize("kind", ["well", "spread"])
def test_schur_f64(kind):
    D = _well(B, 128, 11).astype(np.float64) if kind == "well" else _spread(B, 128, 11)
    assert _rel(spd_kernels.spd_inverse_128_schur(_t(D)), np.linalg.inv(D)) <= 1e-10


@pytest.mark.parametrize("b", [1, 3, 5])
def test_schur_odd_batch_falls_back_to_v3(b, monkeypatch):
    """An odd B runs spd_inverse_unrolled(variant="v3") (JAX :499-500; its
    own rule inverts B < 4 by Cholesky), bit for bit, and no paired sweep."""
    D = _t(_well(b, 128, 12))
    want = spd_kernels.spd_inverse_unrolled(D, variant="v3")

    def no_pairs(*a, **k):
        raise AssertionError("the paired sweep ran on an odd batch")

    monkeypatch.setattr(spd_kernels, "spd_inverse_64p", no_pairs)
    assert torch.equal(spd_kernels.spd_inverse_128_schur(D), want)


def test_paired_sweep_batch_rules():
    """B must be even (JAX's message) and at least 4: at B = 2 JAX's lane
    loop reaches 0 lanes and raises ZeroDivisionError, the port ValueError;
    the Schur inverse at B = 2 raises the same."""
    with pytest.raises(ZeroDivisionError):
        jax_spd.pallas_spd_inverse_64p(jnp.asarray(_well(2, 64, 13)), interpret=True)
    with pytest.raises(ValueError, match="even for pairing"):
        spd_kernels.spd_inverse_64p(_t(_well(5, 64, 13)))
    with pytest.raises(ValueError, match="two pairs"):
        spd_kernels.spd_inverse_64p(_t(_well(2, 64, 13)))
    with pytest.raises(ValueError, match="two pairs"):
        spd_kernels.spd_inverse_128_schur(_t(_well(2, 128, 13)))
    with pytest.raises(ValueError, match=r"blocks must be \(64, 64\)"):
        spd_kernels.spd_inverse_64p(_t(_well(4, 128, 13)))
    with pytest.raises(ValueError, match=r"blocks must be \(128, 128\)"):
        spd_kernels.spd_inverse_128_schur(_t(_well(4, 64, 13)))


@pytest.mark.parametrize("fn, nb", [(spd_kernels.spd_inverse_nb, 128),
                                    (spd_kernels.spd_inverse_64p, 64),
                                    (spd_kernels.spd_inverse_128_schur, 128)])
def test_lanes_change_no_bit(fn, nb):
    """lanes is the TPU kernels' layout knob: every value gives the same
    bits; a non-positive one raises."""
    D = _t(_well(8, nb, 14))
    base = fn(D, lanes=1)
    for lanes in (2, 3, 8, 32):
        assert torch.equal(fn(D, lanes=lanes), base)
    with pytest.raises(ValueError, match="lanes"):
        fn(D, lanes=0)


# ----------------------------------------------- row 12: the normal inverse

def _jax_normal_inputs(case):
    """tests/test_spd_kernels.py:9-37's two cases."""
    if case == "sparse A":
        rng = np.random.default_rng(0)
        b, n, m = 2, 256, 128
        W = rng.standard_normal((b, n, n)).astype(np.float32)
        P = np.einsum("bij,bkj->bik", W, W) / n + 0.01 * np.eye(n, dtype=np.float32)
        A = (rng.standard_normal((b, m, n)) * (rng.random((b, m, n)) < 0.15)).astype(
            np.float32)
        rho = np.full(b, 0.3, np.float32)
    else:
        rng = np.random.default_rng(1)
        b, n, m = 3, 128, 128
        W = rng.standard_normal((b, n, n)).astype(np.float32)
        P = np.einsum("bij,bkj->bik", W, W) / n + 0.1 * np.eye(n, dtype=np.float32)
        A = rng.standard_normal((b, m, n)).astype(np.float32) * 0.1
        rho = np.array([0.1, 1.0, 10.0], np.float32)
    return P.astype(np.float32), A, rho


@pytest.mark.parametrize("case", ["sparse A", "per-lane rho"])
def test_normal_inverse_matches_jax(case):
    """Against JAX's kernel in interpret mode (1e-5 of the output's max, the
    two sum orders apart), and with JAX's own limits against the f64
    inverse: residual |M^-1 M - I| <= 5e-5, relative <= 1e-5."""
    P, A, rho = _jax_normal_inputs(case)
    ref = np.asarray(jax_spd.pallas_normal_inverse(
        jnp.asarray(P), jnp.asarray(A), jnp.asarray(rho), sigma=1e-6,
        interpret=True))
    out = spd_kernels.normal_inverse(_t(P), _t(A), _t(rho), sigma=1e-6).numpy()
    assert out.dtype == np.float32
    assert _rel(out, ref) <= 1e-5
    n = P.shape[-1]
    M = (P.astype(np.float64) + 1e-6 * np.eye(n)
         + rho[:, None, None].astype(np.float64)
         * np.einsum("bki,bkj->bij", A, A, dtype=np.float64))
    resid = np.abs(np.einsum("bij,bjk->bik", out.astype(np.float64), M) - np.eye(n)).max()
    assert resid <= 5e-5, resid
    assert _rel(out, np.linalg.inv(M)) <= 1e-5


def test_normal_inverse_checks():
    P, A, rho = (_t(a) for a in _jax_normal_inputs("per-lane rho"))
    with pytest.raises(ValueError, match="multiples of 128"):
        spd_kernels.normal_inverse(P[:, :100, :100], A[:, :, :100], rho, sigma=0.0)
    with pytest.raises(ValueError, match="multiples of 128"):
        spd_kernels.normal_inverse(P, A[:, :64], rho, sigma=0.0)
    with pytest.raises(ValueError, match=r"rho \(B,\)"):
        spd_kernels.normal_inverse(P, A, rho[:2], sigma=0.0)


def test_normal_inverse_f64():
    """In float64 the plain normal inverse (the unguarded block sweep) is
    the inverse of (P + sigma I) + rho A'A to 1e-10."""
    P, A, rho = (a.astype(np.float64) for a in _jax_normal_inputs("per-lane rho"))
    out = spd_kernels.normal_inverse(_t(P), _t(A), _t(rho), sigma=1e-6)
    M = P + 1e-6 * np.eye(128) + rho[:, None, None] * np.einsum("bki,bkj->bij", A, A)
    assert _rel(out, np.linalg.inv(M)) <= 1e-10


# --------------------------------------------------- the FP32 product scope

def _admm_fleet():
    return device_random_qp_fleet(4, 16, 8, generator=torch.Generator().manual_seed(0))


def _prox_fleet():
    return device_prox_fleet(4, 16, 4, 4, generator=torch.Generator().manual_seed(1))


#: Each entry point: (its inputs, made before the products are watched; the
#: call on them).
ENTRY_POINTS = {
    "admm solve": (_admm_fleet, lambda qp: pt.solve(qp, pt.Settings(max_iterations=50))),
    "prox solve": (_prox_fleet, lambda prob: pt.solve_proxqp(
        prob, pt.ProxQPSettings(max_iterations=50))),
    "prox prepare": (_prox_fleet, pt.prepare_proxqp),
    "prox solve_segmented": (_prox_fleet, lambda prob: pt_proxqp.solve_segmented(
        prob, pt.ProxQPSettings(max_iterations=50), segment_iterations=25)),
    "spd_inverse_sweep": (lambda: _t(_well(4, 256, 15)), spd_kernels.spd_inverse_sweep),
    "spd_inverse_sweep_fused": (lambda: _t(_well(4, 256, 15)),
                                spd_kernels.spd_inverse_sweep_fused),
    "gj_solve_sweep": (lambda: _t(_well(4, 256, 15)),
                       lambda M: spd_kernels.gj_solve_sweep(M, M[..., :3])),
    "spd_inverse_128_schur": (lambda: _t(_well(4, 128, 16)),
                              spd_kernels.spd_inverse_128_schur),
    "normal_inverse": (lambda: [_t(a) for a in _jax_normal_inputs("per-lane rho")],
                       lambda args: spd_kernels.normal_inverse(*args, sigma=1e-6)),
}


def _read(fn):
    try:
        return fn()
    except RuntimeError:  # torch refuses to read mixed legacy/per-backend settings
        return None


def _settings():
    """The float32 product settings as a caller reads them: the matmul
    precision, TF32's flag and, where torch has them, the cuda and mkldnn
    per-backend matmul precisions."""
    return (_read(torch.get_float32_matmul_precision),
            _read(lambda: torch.backends.cuda.matmul.allow_tf32),
            *(getattr(getattr(b, "matmul", None), "fp32_precision", None)
              for b in (torch.backends.cuda, torch.backends.mkldnn)))


@pytest.fixture
def settings_kept():
    """Puts the process's float32 product settings back after the test."""
    matmuls = [m for m in (getattr(torch.backends.cuda, "matmul", None),
                           getattr(torch.backends.mkldnn, "matmul", None))
               if hasattr(m, "fp32_precision")]
    saved = torch.get_float32_matmul_precision(), [m.fp32_precision for m in matmuls]
    yield
    torch.set_float32_matmul_precision(saved[0])
    for m, value in zip(matmuls, saved[1]):
        m.fp32_precision = value


@pytest.fixture
def caller_high(settings_kept):
    """The caller runs with TF32-class products allowed ("high")."""
    torch.set_float32_matmul_precision("high")


#: Ways a caller may have set its float32 products (the legacy calls, the
#: two mixed, and the per-backend setting alone).
CALLERS = {
    "precision high": lambda: torch.set_float32_matmul_precision("high"),
    "precision medium": lambda: torch.set_float32_matmul_precision("medium"),
    "allow_tf32": lambda: setattr(torch.backends.cuda.matmul, "allow_tf32", True),
    "high, then allow_tf32 off": lambda: (
        torch.set_float32_matmul_precision("high"),
        setattr(torch.backends.cuda.matmul, "allow_tf32", False)),
    "per-backend tf32": lambda: setattr(torch.backends.cuda.matmul,
                                        "fp32_precision", "tf32"),
}


@pytest.mark.parametrize("caller", list(CALLERS))
def test_scope_restores_the_callers_settings(caller, settings_kept):
    """Inside the scope products are full FP32 whatever the caller set;
    afterwards every setting reads as the caller left it (a caller that
    turned TF32 on and off again between two solves must not find a
    setting of its own changed)."""
    CALLERS[caller]()
    before = _settings()
    with linalg.fp32_products():
        assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cuda.matmul.allow_tf32 is False
    assert _settings() == before


def test_nested_and_overlapping_scopes_restore_once(settings_kept):
    """Scopes nest, and overlap across threads: an inner or earlier exit
    leaves "highest" for the scopes still open, and the last exit brings
    back the settings the outermost entry found."""
    torch.set_float32_matmul_precision("high")
    with linalg.fp32_products():
        with linalg.fp32_products():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "highest"
    assert torch.get_float32_matmul_precision() == "high"

    entered, first_out = threading.Event(), threading.Event()
    seen = []

    def second():
        with linalg.fp32_products():
            entered.set()
            first_out.wait(10)
            seen.append(torch.get_float32_matmul_precision())

    worker = threading.Thread(target=second)
    with linalg.fp32_products():
        worker.start()
        assert entered.wait(10)
    first_out.set()  # the first scope closed while the second is open
    worker.join(10)
    assert seen == ["highest"]
    assert torch.get_float32_matmul_precision() == "high"


def _record(monkeypatch, seen, fail=False):
    """Wrap torch.matmul and torch.bmm (as the solvers and entry points look them
    up) to record the float32 matmul precision at each call; with ``fail``
    the first call raises after recording."""
    for name in ("matmul", "bmm"):
        orig = getattr(torch, name)

        def wrapped(*a, _orig=orig, **k):
            seen.append(torch.get_float32_matmul_precision())
            if fail:
                raise RuntimeError("product failed")
            return _orig(*a, **k)

        monkeypatch.setattr(torch, name, wrapped)


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_products_run_in_fp32_inside_every_solve(entry, caller_high, monkeypatch):
    """Inside each solve and SPD-inverse entry point torch's products see the
    precision "highest" (the JAX package's matmul_precision scope), and the
    caller's "high" is back afterwards, with allow_tf32 as it was."""
    make, call = ENTRY_POINTS[entry]
    inputs = make()
    seen = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    _record(monkeypatch, seen)
    call(inputs)
    monkeypatch.undo()
    assert seen and set(seen) == {"highest"}, (entry, sorted(set(seen)))
    assert torch.get_float32_matmul_precision() == "high"
    assert torch.backends.cuda.matmul.allow_tf32 == tf32


@pytest.mark.parametrize("entry", ["admm solve", "prox solve", "spd_inverse_sweep"])
def test_precision_restored_after_a_solve_raises(entry, caller_high, monkeypatch):
    make, call = ENTRY_POINTS[entry]
    inputs = make()
    seen = []
    _record(monkeypatch, seen, fail=True)
    with pytest.raises(RuntimeError, match="product failed"):
        call(inputs)
    monkeypatch.undo()
    assert seen == ["highest"]
    assert torch.get_float32_matmul_precision() == "high"
