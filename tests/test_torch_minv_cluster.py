"""Rows 4b and 5b's redesigned kernels, the M^{-1}-form cluster chunks, as the
CPU can check them.

The dispatch rules (``ops/fused_admm.py: minv_chunk_kernel(n, m, lanes,
refine, smem_per_cta)`` and ``ops/fused_proxqp.py: minv_chunk_kernel(n, me,
mi, lanes, refine, smem_per_cta)``, pure functions of the shape), the
shared memory a CTA of each cluster kernel needs against the hand count in
its source's header, the launch keys (",cluster" appended), and the
wrappers that launch one kernel whatever the rule says
(``fused_admm_chunk_minv_streaming``/``_cluster`` and the prox pair): they
refuse what the rule sends elsewhere and, on the CPU, run the plain version,
held here against the JAX package's M^{-1} chunks in interpret mode on the
same numpy inputs. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from quadraticprogramsolver_tpu.ops.fused_admm import fused_admm_chunk as jax_admm_chunk
from quadraticprogramsolver_tpu.ops.fused_proxqp import (
    fused_proxqp_chunk as jax_prox_chunk)

from quadraticprogramsolver_tpu_torch.ops import cluster, fused_admm, fused_proxqp

#: (n, m, lanes, refine) -> the kernel the ADMM M^{-1} rule picks.
RULE = {
    (512, 256, 1, 1): "cluster",    # 7b: the default M^{-1} form, refine 1
    (512, 256, 1, 0): "cluster",    # no P held
    (512, 256, 1, 2): "cluster",
    (128, 128, 1, 1): "cluster",
    (256, 384, 1, 1): "cluster",    # m != n / 2
    (384, 256, 1, 1): "cluster",
    (256, 512, 1, 0): "cluster",
    (512, 256, 2, 1): "cluster",    # lanes 2 (8f): one lane a cluster
    (512, 256, 4, 0): "cluster",
    (512, 256, 8, 1): "cluster",
    (256, 384, 2, 0): "cluster",
    (512, 512, 2, 1): "stream",     # lanes 2 over the registers
    (640, 128, 4, 1): "stream",
    (512, 512, 1, 1): "stream",     # over the registers
    (384, 384, 1, 0): "stream",     # (n/128)(m/128) = 9 > 8
    (640, 128, 1, 1): "stream",     # n over 512
    (1024, 1024, 1, 0): "stream",
    (500, 256, 1, 1): "stream",     # not a multiple of 128
}


@pytest.mark.parametrize("case", list(RULE), ids=lambda c: ",".join(map(str, c)))
def test_minv_chunk_kernel_rule(case):
    assert fused_admm.minv_chunk_kernel(*case) == RULE[case]


#: (n, me, mi, lanes, refine) -> the kernel the prox M^{-1} rule picks.
PROX_RULE = {
    (512, 128, 128, 1, 1): "cluster",   # 7c: the M^{-1} fleet settings
    (512, 128, 128, 1, 0): "cluster",
    (512, 128, 128, 1, 2): "cluster",
    (256, 128, 256, 1, 1): "cluster",   # me + mi = 384
    (128, 128, 128, 1, 1): "cluster",
    (512, 128, 128, 2, 1): "cluster",   # lanes 2 (8g): one lane a cluster
    (512, 128, 128, 4, 0): "cluster",
    (512, 128, 128, 8, 1): "cluster",
    (512, 256, 256, 2, 1): "stream",    # lanes 2 over the registers
    (500, 128, 128, 4, 1): "stream",
    (512, 256, 256, 1, 1): "stream",    # over the registers
    (384, 128, 256, 1, 0): "stream",    # 3 x 3 > 8
    (640, 128, 128, 1, 1): "stream",    # n over 512
    (500, 128, 128, 1, 1): "stream",    # n not 128k
}


@pytest.mark.parametrize("case", list(PROX_RULE), ids=lambda c: ",".join(map(str, c)))
def test_prox_minv_chunk_kernel_rule(case):
    assert fused_proxqp.minv_chunk_kernel(*case) == PROX_RULE[case]


@pytest.mark.parametrize("family", ["admm", "prox"])
def test_minv_rule_reads_the_shared_memory_a_cta_has(family):
    """The rule asks the form's own budget: at 512/256 a CTA's shared
    memory that holds refine 0's lane (no P) but not refine 1's sends
    refine 1 to the streaming kernel, and one float short of refine 1's
    need does too."""
    if family == "admm":
        need = lambda r: fused_admm.minv_cluster_smem_bytes(512, 256, r)
        rule = lambda r, smem: fused_admm.minv_chunk_kernel(512, 256, 1, r, smem)
    else:
        need = lambda r: fused_proxqp.minv_cluster_smem_bytes(512, 128, 128, r)
        rule = lambda r, smem: fused_proxqp.minv_chunk_kernel(512, 128, 128, 1, r,
                                                              smem)
    assert rule(1, need(1)) == "cluster"
    assert rule(1, need(1) - 4) == "stream"
    assert rule(0, need(0)) == "cluster"
    assert rule(1, need(0)) == "stream"


def test_minv_cluster_smem_bytes():
    """The hand count in csrc/admm_chunk_minv_cluster.cu's header: 213,952
    bytes a CTA at 512/256 with refinement, 82,880 without P (5 mbarriers
    in 16 floats, t and u 256 each, rhs, xx, w 512 each, the x and y
    gathers twice, 6 x 64 + 7 x 32 vector rows, 2 x 64 partial sums, 256 x
    64 A columns, 64 x 512 P rows); refine 2 holds the same as refine 1;
    every shape the rule takes fits a CTA, and 12 do."""
    assert fused_admm.minv_cluster_smem_bytes(512, 256, 1) == 213_952 == 4 * (
        16 + 2 * 256 + 3 * 512 + 2 * 768 + 6 * 64 + 7 * 32 + 2 * 64
        + 256 * 64 + 64 * 512)
    assert fused_admm.minv_cluster_smem_bytes(512, 256, 0) == 82_880
    assert (fused_admm.minv_cluster_smem_bytes(512, 256, 2)
            == fused_admm.minv_cluster_smem_bytes(512, 256, 1))
    for refine in (0, 1):
        taken = [(n, m) for n in range(128, 1025, 128) for m in range(128, 1025, 128)
                 if fused_admm.minv_chunk_kernel(n, m, 1, refine) == "cluster"]
        assert len(taken) == 12
        assert all(fused_admm.minv_cluster_smem_bytes(n, m, refine)
                   <= cluster.SMEM_PER_CTA for n, m in taken)


def test_prox_minv_cluster_smem_bytes():
    """The hand count in csrc/prox_chunk_minv_cluster.cu's header: 207,296
    bytes a CTA at n=512, me = mi = 128 with refinement, 76,224 without P (5
    mbarriers, t and u 256 each, rhs, x, w 512 each, 4 x 64 + 3 x 32 vector
    rows, 2 x 2 x 64 partial sums, 256 x 64 columns of [A; C], 64 x 512 P
    rows); only me + mi counts; every (n, me + mi) the rule takes fits."""
    assert fused_proxqp.minv_cluster_smem_bytes(512, 128, 128, 1) == 207_296 == 4 * (
        16 + 2 * 256 + 3 * 512 + 4 * 64 + 3 * 32 + 4 * 64 + 256 * 64 + 64 * 512)
    assert fused_proxqp.minv_cluster_smem_bytes(512, 128, 128, 0) == 76_224
    assert (fused_proxqp.minv_cluster_smem_bytes(512, 64, 192, 1)
            == fused_proxqp.minv_cluster_smem_bytes(512, 128, 128, 1))
    for refine in (0, 1):
        taken = [(n, mt) for n in range(128, 1025, 128) for mt in range(256, 1025, 256)
                 if fused_proxqp.minv_chunk_kernel(n, mt // 2, mt // 2, 1, refine)
                 == "cluster"]
        assert all(fused_proxqp.minv_cluster_smem_bytes(n, mt // 2, mt // 2, refine)
                   <= cluster.SMEM_PER_CTA for n, mt in taken)


KEYS = {
    ("admm", (512, 256, 1, 1)): "lanes1,cluster",
    ("admm", (512, 256, 2, 1)): "lanes2,cluster",
    ("admm", (512, 256, 4, 0)): "lanes4,cluster",
    ("admm", (640, 128, 2, 1)): "lanes2",
    ("admm", (640, 128, 1, 1)): "lanes1",
    ("prox", (512, 128, 128, 1, 1)): "lanes1,cluster",
    ("prox", (512, 128, 128, 2, 1)): "lanes2,cluster",
    ("prox", (640, 128, 128, 2, 1)): "lanes2",
    ("prox", (512, 256, 256, 1, 0)): "lanes1",
}


@pytest.mark.parametrize("case", list(KEYS), ids=lambda c: f"{c[0]}:{c[1]}")
def test_minv_chunk_variant_key(case):
    family, shape = case
    mod = fused_admm if family == "admm" else fused_proxqp
    assert mod.minv_chunk_variant(*shape) == KEYS[case]


def test_minv_cluster_wrappers_refuse_what_the_rule_sends_elsewhere():
    B = 2
    for n, m, refine in ((640, 128, 1), (512, 512, 0), (384, 384, 1)):
        z = [torch.zeros((B, w)) for w in (n, m, m, n, m, m, m)]
        with pytest.raises(ValueError, match="do not fit a cluster of 8 CTAs"):
            fused_admm.fused_admm_chunk_minv_cluster(
                torch.zeros((B, n, n)), torch.zeros((B, m, n)),
                torch.zeros((B, n, n)), *z, torch.ones(B, dtype=torch.bool),
                K=1, alpha=1.6, sigma=1e-6, refine=refine)
    for n, me, mi in ((1024, 256, 256), (640, 128, 128), (384, 128, 256)):
        z = [torch.zeros((B, w)) for w in (n, me, mi, n, mi, me, mi)]
        with pytest.raises(ValueError, match="do not fit a cluster of 8 CTAs"):
            fused_proxqp.fused_proxqp_chunk_minv_cluster(
                torch.zeros((B, n, n)), torch.zeros((B, me, n)),
                torch.zeros((B, mi, n)), torch.zeros((B, n, n)), *z,
                torch.ones(B), torch.ones(B, dtype=torch.bool), K=1,
                sigma=1e-2, refine=1)


# -- the one-kernel wrappers against JAX (plain versions on the CPU) --

B, N, M, K = 4, 128, 128, 5
ACTIVE = np.array([True, False, True, True])
#: Relative limit (to max(|JAX|, 1)): both sides are FP32 with another
#: summation order over at most 128 terms per product.
REL = 1e-5
#: The M^{-1} operand is the inverse of M + SHIFT*I: inexact, so that each
#: refinement pass moves the outputs far past REL (as in
#: tests/test_torch_minv_chunk.py).
SHIFT = 0.05


def _admm_inputs(seed):
    """The f32 operands of the ADMM M^{-1} chunk (sigma 1e-6, rho 0.1) on a
    random fleet whose P is SPD."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, N, N))
    P = np.swapaxes(X, 1, 2) @ X / N + np.eye(N)
    A = rng.standard_normal((B, M, N)) / np.sqrt(N)
    q = rng.standard_normal((B, N))
    l, u = -np.abs(rng.standard_normal((B, M))), np.abs(rng.standard_normal((B, M)))
    sigma, rho = 1e-6, np.full((B, M), 0.1)
    Mn = P + sigma * np.eye(N) + np.swapaxes(A, 1, 2) @ (rho[:, :, None] * A)
    Minv = np.linalg.inv(Mn + SHIFT * np.eye(N))
    Minv = 0.5 * (Minv + np.swapaxes(Minv, 1, 2))   # both contractions agree
    x, z, y = (rng.standard_normal((B, w)) for w in (N, M, M))
    f32 = [v.astype(np.float32) for v in (Minv, A, P, q, l, u, x, z, y, rho)]
    return sigma, f32 + [ACTIVE]


def _prox_inputs(seed):
    """The f32 operands of the prox M^{-1} chunk (sigma 1e-2, rho in [0.05,
    0.5]) on a split-form fleet, me = mi = 128."""
    me = mi = 128
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, N, N))
    P = np.swapaxes(X, 1, 2) @ X / N + np.eye(N)
    A = rng.standard_normal((B, me, N))
    C = rng.standard_normal((B, mi, N))
    q = rng.standard_normal((B, N))
    xf = rng.standard_normal((B, N))
    b = np.einsum("bij,bj->bi", A, xf)
    d = np.einsum("bij,bj->bi", C, xf) + 1.0
    rho, sigma = rng.uniform(0.05, 0.5, B), 1e-2
    Mn = P + sigma * np.eye(N) + rho[:, None, None] * (
        np.swapaxes(A, 1, 2) @ A + np.swapaxes(C, 1, 2) @ C)
    Minv = np.linalg.inv(Mn + SHIFT * np.eye(N))
    Minv = 0.5 * (Minv + np.swapaxes(Minv, 1, 2))
    x = rng.standard_normal((B, N))
    s = np.abs(rng.standard_normal((B, mi)))
    y = rng.standard_normal((B, me))
    z = np.abs(rng.standard_normal((B, mi)))
    f32 = [v.astype(np.float32) for v in (Minv, A, C, P, q, b, d, x, s, y, z, rho)]
    return sigma, f32 + [ACTIVE]


def _t(arrs):
    return tuple(torch.from_numpy(np.array(a, order="C")) for a in arrs)


def _assert_rel(name, out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1.0)
    assert err <= REL, (name, err)


@pytest.fixture(scope="module")
def jax_admm():
    """JAX's M^{-1} ADMM chunk in interpret mode at refine 0 and 1, once."""
    cases = {}
    for refine in (0, 1):
        sigma, arrs = _admm_inputs(20 + refine)
        kw = dict(K=K, alpha=1.6, sigma=sigma, refine=refine)
        cases[refine] = (arrs, kw, jax_admm_chunk(*arrs, interpret=True, **kw))
    return cases


@pytest.fixture(scope="module")
def jax_prox():
    """JAX's M^{-1} prox chunk in interpret mode at refine 0 and 1, once."""
    cases = {}
    for refine in (0, 1):
        sigma, arrs = _prox_inputs(30 + refine)
        kw = dict(K=K, sigma=sigma, refine=refine)
        cases[refine] = (arrs, kw, jax_prox_chunk(*arrs, interpret=True, **kw))
    return cases


@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("wrapper", ["fused_admm_chunk_minv_cluster",
                                     "fused_admm_chunk_minv_streaming",
                                     "fused_admm_chunk_minv"])
def test_admm_minv_wrappers_match_jax_on_cpu(jax_admm, wrapper, refine):
    """Each wrapper runs the plain version on a CPU tensor (bit for bit)
    and matches JAX's chunk within REL on all seven outputs; the frozen
    lane passes through with prev = current."""
    arrs, kw, ref = jax_admm[refine]
    ins = _t(arrs)
    run = getattr(fused_admm, wrapper)
    out = run(*ins, **kw)
    plain = fused_admm.fused_admm_chunk_minv_plain(*ins, **kw)
    for name, o, p, r in zip(("x", "z", "y", "x_prev", "z_prev", "Ax", "ATy"),
                             out, plain, ref):
        assert torch.equal(o, p), name
        _assert_rel(name, o.numpy(), r)
    x, z, y = arrs[6:9]
    for o, v in ((out[0], x), (out[3], x), (out[1], z), (out[4], z), (out[2], y)):
        np.testing.assert_array_equal(o[1].numpy(), v[1])


@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("wrapper", ["fused_proxqp_chunk_minv_cluster",
                                     "fused_proxqp_chunk_minv_streaming",
                                     "fused_proxqp_chunk_minv"])
def test_prox_minv_wrappers_match_jax_on_cpu(jax_prox, wrapper, refine):
    """As for ADMM: plain on the CPU, JAX within REL on x, s, y, z, the
    frozen lane's inputs passed through."""
    arrs, kw, ref = jax_prox[refine]
    ins = _t(arrs)
    run = getattr(fused_proxqp, wrapper)
    out = run(*ins, **kw)
    plain = fused_proxqp.fused_proxqp_chunk_minv_plain(*ins, **kw)
    for name, o, p, r, v0 in zip("xsyz", out, plain, ref, arrs[7:11]):
        assert torch.equal(o, p), name
        _assert_rel(name, o.numpy(), r)
        np.testing.assert_array_equal(o.numpy()[~ACTIVE], v0[~ACTIVE])

