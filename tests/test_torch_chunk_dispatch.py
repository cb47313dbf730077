"""Rows 2 and 4a's redesigned kernels as the CPU can check them.

The sigma-free chunk's dispatch rule (``ops/fused_admm.py: chunk_kernel``,
a pure function of n, m, lanes, precision, G source and shared memory a
CTA), its launch keys and the cluster kernel's shared-memory size; the
wrappers that launch one kernel whatever the rule says (the streaming and
cluster chunks, the previous v3 pivot kernel) against the JAX package's
chunk in interpret mode and the v3 plain version; and every C entry point
of ``csrc`` against the signature ``_build`` gives ctypes. The kernels
themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.models import kkt as jax_kkt
from quadraticprogramsolver_tpu.ops.fused_admm import (
    fused_admm_chunk as jax_admm_chunk)
from quadraticprogramsolver_tpu.ops.spd_kernels import pallas_spd_inverse_unrolled

from quadraticprogramsolver_tpu_torch import _build
from quadraticprogramsolver_tpu_torch.ops import fused_admm, spd_kernels

# (n, m, lanes, dot_precision, source) -> the kernel the rule picks.
RULE = {
    (512, 256, 1, "highest", "G"): "cluster",      # the main path
    (512, 256, 1, "highest", "slab"): "cluster",   # the slab window
    (128, 128, 1, "highest", "G"): "cluster",
    (256, 384, 1, "highest", "G"): "cluster",      # m != n / 2
    (256, 512, 1, "highest", "slab"): "cluster",   # 8 (n/128)(m/128) = 64
    (384, 256, 1, "highest", "G"): "cluster",
    (512, 256, 2, "highest", "G"): "stream",       # lanes 2
    (512, 256, 4, "highest", "slab"): "stream",    # bench.py's slab_hi
    (512, 256, 1, "high", "G"): "stream",          # bf16x3
    (512, 256, 1, "default", "slab"): "stream",    # one bf16 pass
    (512, 256, 1, "high", "split"): "stream",      # bf16 halves
    (512, 512, 1, "highest", "G"): "stream",       # over the registers
    (640, 128, 1, "highest", "G"): "stream",       # n over 512
    (1024, 1024, 1, "highest", "G"): "stream",
    (500, 256, 1, "highest", "G"): "stream",       # not a multiple of 128
}


@pytest.mark.parametrize("case", list(RULE), ids=lambda c: ",".join(map(str, c)))
def test_chunk_kernel_rule(case):
    assert fused_admm.chunk_kernel(*case) == RULE[case]


def test_chunk_kernel_rule_reads_the_shared_memory_a_cta_has():
    need = fused_admm.cluster_smem_bytes(512, 256)
    assert fused_admm.chunk_kernel(512, 256, 1, "highest", "G",
                                   smem_per_cta=need) == "cluster"
    assert fused_admm.chunk_kernel(512, 256, 1, "highest", "G",
                                   smem_per_cta=need - 4) == "stream"


def test_cluster_smem_bytes():
    """4 mbarriers (16 floats), the next lane's 64 G rows of 256 and 32 A
    rows of 512 and this lane's 64 A columns of 256, t and xx twice, the x
    and y gathers twice, 3 x 64 + 7 x 32 vector rows, 2 x 64 partial sums;
    every shape the rule takes fits a CTA."""
    assert fused_admm.cluster_smem_bytes(512, 256) == 4 * (
        16 + 3 * 64 * 256 + 4 * 768 + 3 * 64 + 7 * 32 + 2 * 64)
    taken = [(n, m) for n in range(128, 1025, 128) for m in range(128, 1025, 128)
             if fused_admm.chunk_kernel(n, m, 1, "highest", "G") == "cluster"]
    assert len(taken) == 12
    assert all(fused_admm.cluster_smem_bytes(n, m) <= fused_admm.SMEM_PER_CTA
               for n, m in taken)


VARIANT_KEYS = {
    (512, 256, 1, "highest", "G"): "highest,G,lanes1,cluster",
    (512, 256, 1, "highest", "slab"): "highest,slab,lanes1,cluster",
    (512, 256, 2, "high", "slab"): "high,slab,lanes2",
    (512, 256, 4, "highest", "slab"): "highest,slab,lanes4",
    (512, 256, 2, "high", "split"): "high,split,lanes2",
    (1024, 512, 1, "highest", "G"): "highest,G,lanes1",
}


@pytest.mark.parametrize("case", list(VARIANT_KEYS),
                         ids=lambda c: ",".join(map(str, c)))
def test_chunk_variant_key(case):
    assert fused_admm.chunk_variant(*case) == VARIANT_KEYS[case]


def _chunk_case(seed=3, B=4, n=128):
    qp = qps.pad_qp(qps.generate_batch(qps.ProblemClass.RANDOM_QP, batch=B,
                                       num_elements=100, seed=0,
                                       dtype=np.float32), n, n)
    st = qps.Settings(rho=0.4, kkt_refinement_steps=0, sigma_free_rhs=True)
    cache = jax_kkt.cholesky_init(qp, jnp.full((B,), 0.4, jnp.float32),
                                  jnp.float32(1e-6), st)
    rng = np.random.default_rng(seed)
    x, z, y = (rng.standard_normal((B, n)).astype(np.float32) for _ in range(3))
    rho_row = np.full((B, n), 0.4, np.float32)
    active = np.array([True, True, True, False])
    return qp, np.asarray(cache["G"]), np.asarray(cache["g"]), x, z, y, rho_row, active


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("slab", [False, True])
def test_one_kernel_wrappers_match_jax_on_cpu(slab):
    """The cluster and streaming wrappers and the dispatching chunk run the
    same plain version on the CPU: bit for bit one another, within 1e-5 of
    each output's max of JAX's chunk (interpret mode), every fourth lane
    frozen, from a contiguous G or the slab window."""
    qp, G, g, x, z, y, rho_row, active = _chunk_case()
    vecs = (qp.l, qp.u, x, z, y, rho_row, active)
    kw = dict(K=5, alpha=1.6)
    if slab:
        junk = np.random.default_rng(4).standard_normal(G.shape).astype(np.float32)
        G = np.concatenate([G, junk], axis=-1)
    ref = jax_admm_chunk(G, qp.A, None, None, *vecs, sigma=1e-6,
                         sigma_free=True, g=g, slab=slab, interpret=True, **kw)
    args = (_t(G), _t(qp.A), _t(g), *(_t(v) for v in vecs[:-1]),
            torch.from_numpy(active))
    outs = [fused_admm.fused_admm_chunk(*args, slab=slab, **kw),
            fused_admm.fused_admm_chunk_streaming(*args, slab=slab, **kw),
            fused_admm.fused_admm_chunk_cluster(*args, slab=slab, **kw)]
    names = ("x", "z", "y", "x_prev", "z_prev", "Ax", "ATy")
    for i, name in enumerate(names):
        r = np.asarray(ref[i])
        assert np.abs(r - outs[0][i].numpy()).max() <= 1e-5 * np.abs(r).max(), name
        assert all(torch.equal(o[i], outs[0][i]) for o in outs[1:]), name
    frozen = torch.from_numpy(~active)
    assert torch.equal(outs[2][0][frozen], args[5][frozen])


def test_cluster_wrapper_refuses_what_the_rule_sends_elsewhere():
    n, m, B = 1024, 512, 2
    z = [torch.zeros((B, w)) for w in (n, m, m, n, m, m, m)]
    with pytest.raises(ValueError, match="do not fit a cluster of 8 CTAs"):
        fused_admm.fused_admm_chunk_cluster(
            torch.zeros((B, n, m)), torch.zeros((B, m, n)), z[0], z[1], z[2],
            z[3], z[4], z[5], z[6], torch.ones(B, dtype=torch.bool), K=1,
            alpha=1.6)


def test_pivot_v3_prev_is_the_v3_plain_version_on_cpu():
    """On the CPU the previous v3 kernel's wrapper runs v3's plain version,
    bit for bit, whose JAX parity test_torch_spd_kernels.py holds; here
    against JAX's v3 kernel (interpret mode) at B=4, and an f64 inverse."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((4, 128, 128))
    D = (X @ np.swapaxes(X, 1, 2) / 128 + np.eye(128)).astype(np.float32)
    prev = spd_kernels.pivot_sweep_v3_prev(torch.from_numpy(D))
    assert torch.equal(prev, spd_kernels.pivot_sweep_v3_plain(torch.from_numpy(D)))
    ref = np.asarray(pallas_spd_inverse_unrolled(D, variant="v3", interpret=True))
    assert np.abs(prev.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    exact = np.linalg.inv(D.astype(np.float64))
    assert np.abs(prev.numpy() - exact).max() <= 1e-5 * np.abs(exact).max()
    with pytest.raises(ValueError, match="blocks must be"):
        spd_kernels.pivot_sweep_v3_prev(torch.zeros((4, 64, 64)))


def _entry_points():
    """(name, parameter count) of every ``extern "C" int qps_...`` in csrc."""
    found = {}
    for path in sorted(_build.SRC_DIR.glob("*.cu")):
        text = path.read_text()
        for name, params in re.findall(r'extern "C" int (qps_\w+)\(([^)]*)\)', text):
            found[name] = len([p for p in params.split(",") if p.strip()])
    return found


def test_every_c_entry_point_has_its_ctypes_signature():
    """ctypes passes each argument by the type _build names for it, so an
    entry point whose parameter count differs would read garbage."""
    entries = _entry_points()
    assert {"qps_pivot_sweep_v3", "qps_pivot_sweep_v3_prev",
            "qps_admm_chunk", "qps_admm_chunk_cluster"} <= set(entries)
    assert entries == {k: len(v) for k, v in _build._SIGNATURES.items()}
