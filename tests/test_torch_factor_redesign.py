"""Rows 1 and 3's redesigned kernels as the CPU can check them.

The fused factor's dispatch rules (``ops/fused_factor.py: build_kernel``, a
pure function of n; ``level_kernel``, of the level's precision: a strip
kernel at both, bf16x6 at "highest" and bf16x3 at "high"), the "highest"
strip kernel's bf16x6 arithmetic in plain PyTorch (``bf16_split3``,
``_dot6``: the split exact, the whole factor within 1.5x FP32's error
against float64), the witness wrappers that
launch the previous kernels on the card (``build_slab_prev``,
``slab_level_prev``: their plain versions here) against their plain versions
and, through a whole factor, against the JAX package's fused factor in
interpret mode, and the level's scratch rule (no level of the factor takes
one). The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from quadraticprogramsolver_tpu.ops.fused_factor import (
    fused_factor_solve as jax_fused_factor_solve)

from quadraticprogramsolver_tpu_torch.ops import fused_factor, spd_kernels

B, N = 4, 256
SIGMA = 1e-6
#: The port's FP32 factor against JAX's (interpret mode) on the same f32
#: inputs: both sum the same products in other orders, and two 128-blocks
#: of pivots amplify the rounding by their conditioning (tens), so the
#: solves agree to a few 1e-7 of their max; 1e-5 as
#: tests/test_torch_fused_factor.py holds them.
REL = 1e-5

# n -> the build the rule picks.
BUILD_RULE = {
    128: "triangle",
    256: "triangle",
    512: "triangle",      # the main paths, 500/250 padded to 512/256
    1024: "triangle",
    64: "square",         # n % 128 == 64: the previous kernels
    192: "square",
    320: "square",
}


@pytest.mark.parametrize("n", list(BUILD_RULE))
def test_build_kernel_rule(n):
    assert fused_factor.build_kernel(n) == BUILD_RULE[n]


@pytest.mark.parametrize("prec,kernel", [("highest", "strip_x6"), ("high", "strip")])
def test_level_kernel_rule(prec, kernel):
    assert fused_factor.level_kernel(prec) == kernel


def _inputs(ms, seed, n=N, dtype=np.float32):
    """P, the row blocks, q and rho, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((B, n, n)) * (rng.random((B, n, n)) < 0.15)
    P = np.swapaxes(Mm, 1, 2) @ Mm + 1e-2 * np.eye(n)
    blocks = tuple(rng.standard_normal((B, mb, n)) * (rng.random((B, mb, n)) < 0.15)
                   for mb in ms)
    q = rng.standard_normal((B, n))
    rho = rng.uniform(0.1, 2.0, (B, sum(ms)))
    cast = lambda v: v.astype(dtype)  # noqa: E731
    return cast(P), tuple(map(cast, blocks)), cast(q), cast(rho)


def _torch(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def _torch_inputs(ms, seed, dtype=np.float32):
    P, blocks, q, rho = _inputs(ms, seed, dtype=dtype)
    return _torch(P)[0], _torch(*blocks), *_torch(q, rho)


def _prev_factor(P, blocks, q, rho):
    """The factor through the witness wrappers: build_slab_prev, then every
    level through slab_level_prev."""
    n, m = q.shape[-1], rho.shape[-1]
    kp = fused_factor.slab_k(m)
    S = fused_factor.build_slab_prev(P, blocks, q, rho, SIGMA)
    for j in range(n // 128 - 1, -1, -1):
        w_out = kp + j * 128
        Dinv = spd_kernels.spd_inverse_unrolled(
            S[:, j * 128:(j + 1) * 128, w_out:w_out + 128])
        fused_factor.slab_level_prev(S, Dinv, j, w_out)
    return S


@pytest.mark.parametrize("ms", [(128,), (128, 128)], ids=["one_block", "two_blocks"])
def test_witness_factor_matches_jax_interpret(ms):
    """The witness wrappers' factor (their plain versions on the CPU)
    against the JAX package's fused factor in interpret mode, one row block
    and the prox family's two (JAX takes blocks of a multiple of 128 rows):
    X = M^{-1} [A' | q] within REL of its max."""
    P, blocks, q, rho = _inputs(ms, 3)
    m = sum(ms)
    A = blocks if len(blocks) > 1 else blocks[0]
    S_j = np.asarray(jax_fused_factor_solve(P, A, q, rho, sigma=SIGMA,
                                            interpret=True))
    S_p = _prev_factor(*_torch_inputs(ms, 3))
    # The right-hand blocks differ in width (the port's kp is m + 64, the
    # TPU's m + 128): compare X = M^{-1}[A' | q].
    X_j, X_p = S_j[..., :m + 1], S_p[..., :m + 1].numpy()
    err = np.abs(X_j - X_p).max() / np.abs(X_j).max()
    assert err <= REL, err


@pytest.mark.parametrize("ms", [(64,), (64, 64)], ids=["one_block", "two_blocks"])
def test_witness_wrappers_run_their_plain_versions_on_cpu(ms):
    """On CPU tensors build_slab_prev and slab_level_prev are their plain
    versions, bit for bit, and leave the pivot columns alone."""
    P, blocks, q, rho = _torch_inputs(ms, 4, np.float64)
    S = fused_factor.build_slab_prev(P, blocks, q, rho, SIGMA)
    assert torch.equal(S, fused_factor.build_slab_plain(P, blocks, q, rho, SIGMA))
    kp = fused_factor.slab_k(sum(ms))
    for j in range(N // 128 - 1, -1, -1):
        w_out = kp + j * 128
        Dinv = torch.linalg.inv(S[:, j * 128:(j + 1) * 128, w_out:w_out + 128])
        before, ref = S.clone(), S.clone()
        fused_factor.slab_level_prev(S, Dinv, j, w_out)
        fused_factor.slab_level_plain(ref, Dinv, j, w_out)
        assert torch.equal(S, ref)
        assert torch.equal(S[..., w_out:], before[..., w_out:])


@pytest.mark.parametrize("prec", ["highest", "high"])
def test_fused_factor_solve_takes_a_scratch_only_for_the_tiles_level(
        monkeypatch, prec):
    """Both precisions run the strip level, which takes no scratch: every
    level gets the slab, Dinv, j, w_out and the precision alone, and the
    factor allocates no (B, 128, w) buffer. The slab is the same as with
    the unpatched levels."""
    P, blocks, q, rho = _torch_inputs((128,), 5)
    args = (P, blocks[0], q, rho)
    ref = fused_factor.fused_factor_solve(*args, sigma=SIGMA, dot_precision=prec)
    seen, shapes = [], []
    level, empty = fused_factor.slab_level, torch.empty

    def spy(S, Dinv, j, w_out, *rest, **kw):
        seen.append((rest, kw))
        return level(S, Dinv, j, w_out, *rest, **kw)

    def spy_empty(*shape, **kw):
        shapes.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return empty(*shape, **kw)

    monkeypatch.setattr(fused_factor, "slab_level", spy)
    monkeypatch.setattr(torch, "empty", spy_empty)
    S = fused_factor.fused_factor_solve(*args, sigma=SIGMA, dot_precision=prec)
    monkeypatch.undo()
    assert torch.equal(S, ref)
    assert seen == [((prec,), {})] * (N // 128)
    assert not [s for s in shapes if len(s) == 3 and s[:2] == (B, 128)], shapes


def test_witness_wrappers_reject_other_devices():
    P, blocks, q, rho = _torch_inputs((64,), 6)
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="device"):
        fused_factor.build_slab_prev(meta(P), tuple(map(meta, blocks)),
                                     meta(q), meta(rho), SIGMA)
    S = torch.zeros((B, N, 128 + N), device="meta")
    with pytest.raises(ValueError, match="device"):
        fused_factor.slab_level_prev(S, torch.zeros((B, 128, 128), device="meta"),
                                     0, 128)


# ---------------------------- row 3's bf16x6 arithmetic, in plain PyTorch

#: Exponent ranges of the float32 values the three-way split is held to:
#: down to 2^-110 (lo at bfloat16's least subnormal) and below 2^127.
SPLIT_EXPONENTS = {"unit": (-4, 4), "tiny": (-110, -60), "huge": (60, 126)}
#: The bf16x6 factor's error against float64 over FP32 matmul's.
GATE = 1.5


@pytest.mark.parametrize("family", list(SPLIT_EXPONENTS))
def test_bf16_split3_is_exact(family):
    """hi + mid + lo == x for float32 x with every significand bit drawn,
    both signs and exponents over the family's range, and for 0: each piece
    a bfloat16, hi = bf16(x). The three pieces hold the 24-bit significand,
    so bf16x6's products see the FP32 operands whole."""
    lo_e, hi_e = SPLIT_EXPONENTS[family]
    rng = np.random.default_rng(11)
    sig = rng.integers(2 ** 23, 2 ** 24, 20000).astype(np.float64)
    exp = rng.integers(lo_e, hi_e + 1, sig.size)
    x = np.ldexp(sig, exp - 23) * rng.choice([-1.0, 1.0], sig.size)
    x = torch.from_numpy(np.append(x, 0.0).astype(np.float32))
    pieces = fused_factor.bf16_split3(x)
    assert all(p.dtype == torch.bfloat16 for p in pieces)
    assert torch.equal(pieces[0], x.to(torch.bfloat16))
    assert torch.equal(sum(p.double() for p in pieces), x.double())


def _gauss_jordan(S, mm, inv):
    """The factor's levels on slab S in place, every product by ``mm`` and
    every pivot inverse by ``inv``; returns X = S[..., :kp]."""
    n = S.shape[1]
    kp = S.shape[2] - n
    for j in range(n // 128 - 1, -1, -1):
        w_out, rows = kp + j * 128, slice(j * 128, (j + 1) * 128)
        DinvT = mm(inv(S[:, rows, w_out:w_out + 128]), S[:, rows, :w_out])
        S[:, :, :w_out] -= mm(S[:, :, w_out:w_out + 128], DinvT)
        S[:, rows, :w_out] = DinvT
    return S[..., :kp]


def _errors(x, ref):
    """(max |x - ref| / max |ref|, ||x - ref||_F / ||ref||_F)."""
    d = x.double() - ref
    return float(d.abs().max() / ref.abs().max()), float(d.norm() / ref.norm())


def test_dot6_gauss_jordan_holds_fp32_error():
    """The whole four-level factor at the cells' shape (n = 512, m = 256,
    P and A at density 0.15, rho 0.4, sigma 1e-6) with every level product
    in bf16x6 (``_dot6``) against a float64 run of the same slab: max
    relative and relative Frobenius error within GATE of the FP32
    (torch.matmul) run's. Both FP32 runs invert the pivots with the v3
    sweep's plain version."""
    b, n, m = 2, 512, 256
    rng = np.random.default_rng(12)
    Mm = rng.standard_normal((b, n, n)) * (rng.random((b, n, n)) < 0.15)
    P = np.swapaxes(Mm, 1, 2) @ Mm + 1e-2 * np.eye(n)
    A = rng.standard_normal((b, m, n)) * (rng.random((b, m, n)) < 0.15)
    q = rng.standard_normal((b, n))
    P, A, q = _torch(*(a.astype(np.float32) for a in (P, A, q)))
    S = fused_factor.build_slab_plain(P, A, q, torch.full((b, m), 0.4), SIGMA)
    ref = _gauss_jordan(S.double(), torch.matmul, torch.linalg.inv)
    inv = spd_kernels.pivot_sweep_v3_plain
    fp32 = _errors(_gauss_jordan(S.clone(), torch.matmul, inv), ref)
    x6 = _errors(_gauss_jordan(S.clone(), fused_factor._dot6, inv), ref)
    assert all(e <= GATE * f for e, f in zip(x6, fp32)), (x6, fp32)
