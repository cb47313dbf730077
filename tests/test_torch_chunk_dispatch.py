"""Rows 2, 4a and 5a's redesigned kernels as the CPU can check them.

The sigma-free chunks' dispatch rules (``ops/fused_admm.py: chunk_kernel``,
a pure function of n, m, lanes, precision, G source and shared memory a
CTA; ``ops/fused_proxqp.py: chunk_kernel``, of n, me, mi, lanes, precision
and shared memory), their launch keys and the cluster kernels'
shared-memory sizes; the wrappers that launch one kernel whatever the rule
says (the streaming and cluster chunks of both families, the previous v3
pivot kernel) against the JAX package's chunks (the ADMM one in interpret
mode, the prox kernel's body called eagerly) and the v3 plain version; and
every C entry point of ``csrc`` against the signature ``_build`` gives
ctypes. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.models import kkt as jax_kkt
from quadraticprogramsolver_tpu.ops import fused_proxqp as jax_fused_proxqp
from quadraticprogramsolver_tpu.ops.fused_admm import (
    fused_admm_chunk as jax_admm_chunk)
from quadraticprogramsolver_tpu.ops.spd_kernels import pallas_spd_inverse_unrolled

from quadraticprogramsolver_tpu_torch import _build
from quadraticprogramsolver_tpu_torch.ops import (cluster, fused_admm, fused_proxqp,
                                                  linalg, spd_kernels)

# (n, m, lanes, dot_precision, source) -> the kernel the rule picks.
RULE = {
    (512, 256, 1, "highest", "G"): "cluster",      # the main path
    (512, 256, 1, "highest", "slab"): "cluster",   # the slab window
    (128, 128, 1, "highest", "G"): "cluster",
    (256, 384, 1, "highest", "G"): "cluster",      # m != n / 2
    (256, 512, 1, "highest", "slab"): "cluster",   # 8 (n/128)(m/128) = 64
    (384, 256, 1, "highest", "G"): "cluster",
    (512, 256, 2, "highest", "G"): "cluster",      # lanes 2: one lane a cluster
    (512, 256, 4, "highest", "slab"): "cluster",   # bench.py's slab_hi
    (512, 256, 1, "high", "G"): "cluster",         # bf16x3
    (512, 256, 1, "default", "slab"): "cluster",   # one bf16 pass
    (512, 256, 1, "high", "split"): "cluster",     # bf16 halves
    (512, 256, 2, "high", "slab"): "cluster",      # bench.py's slab_settings
    (512, 256, 2, "default", "slab"): "cluster",   # its first chunk
    (512, 256, 2, "high", "split"): "cluster",     # the split stack
    (256, 512, 4, "high", "G"): "cluster",         # "high" at m = 512
    (384, 256, 8, "default", "G"): "cluster",
    (512, 512, 1, "highest", "G"): "stream",       # over the registers
    (512, 512, 2, "high", "slab"): "stream",
    (640, 128, 1, "highest", "G"): "stream",       # n over 512
    (640, 128, 2, "high", "split"): "stream",
    (1024, 1024, 1, "highest", "G"): "stream",
    (500, 256, 1, "highest", "G"): "stream",       # not a multiple of 128
    (500, 256, 2, "default", "slab"): "stream",
}
# Lanes 2, 4 and 8 at every precision and source run the kernel lanes 1
# runs, on a shape that fits a cluster and on three that do not.
SOURCES = (("highest", "G"), ("highest", "slab"), ("high", "G"), ("high", "slab"),
           ("high", "split"), ("default", "G"), ("default", "slab"))
LANES_RULE = {(n, m, lanes, prec, src): kernel
              for (n, m), kernel in (((512, 256), "cluster"), ((640, 128), "stream"),
                                     ((512, 512), "stream"), ((500, 256), "stream"))
              for lanes in (2, 4, 8) for prec, src in SOURCES}


@pytest.mark.parametrize("case", list(LANES_RULE), ids=lambda c: ",".join(map(str, c)))
def test_chunk_kernel_rule_ignores_lanes(case):
    assert fused_admm.chunk_kernel(*case) == LANES_RULE[case]
    assert fused_admm.chunk_kernel(case[0], case[1], 1, *case[3:]) == LANES_RULE[case]


@pytest.mark.parametrize("case", list(RULE), ids=lambda c: ",".join(map(str, c)))
def test_chunk_kernel_rule(case):
    assert fused_admm.chunk_kernel(*case) == RULE[case]


def test_chunk_kernel_rule_reads_the_shared_memory_a_cta_has():
    need = fused_admm.cluster_smem_bytes(512, 256)
    assert fused_admm.chunk_kernel(512, 256, 1, "highest", "G",
                                   smem_per_cta=need) == "cluster"
    assert fused_admm.chunk_kernel(512, 256, 1, "highest", "G",
                                   smem_per_cta=need - 4) == "stream"
    # Each precision asks its own need: a CTA that holds "highest"'s lane
    # but not "high"'s (two floats an exchanged element) sends "high", from
    # every source, to the streaming kernel.
    high = fused_admm.cluster_smem_bytes(512, 256, "high")
    assert high > need
    for lanes in (1, 2):
        assert fused_admm.chunk_kernel(512, 256, lanes, "default", "slab",
                                       smem_per_cta=need) == "cluster"
        for src in ("G", "slab", "split"):
            assert fused_admm.chunk_kernel(512, 256, lanes, "high", src,
                                           smem_per_cta=high - 4) == "stream"
            assert fused_admm.chunk_kernel(512, 256, lanes, "high", src,
                                           smem_per_cta=high) == "cluster"


def test_cluster_smem_bytes():
    """4 mbarriers (16 floats), the next lane's 64 G rows of 256 and 32 A
    rows of 512 and this lane's 64 A columns of 256, t and xx twice, the x
    and y gathers twice, 3 x 64 + 7 x 32 vector rows, 2 x 64 partial sums;
    every shape the rule takes fits a CTA."""
    assert fused_admm.cluster_smem_bytes(512, 256) == 4 * (
        16 + 3 * 64 * 256 + 4 * 768 + 3 * 64 + 7 * 32 + 2 * 64)
    for prec in ("highest", "high", "default"):
        taken = [(n, m) for n in range(128, 1025, 128)
                 for m in range(128, 1025, 128)
                 if fused_admm.chunk_kernel(n, m, 1, prec, "G") == "cluster"]
        assert len(taken) == 12, prec
        assert all(fused_admm.cluster_smem_bytes(n, m, prec)
                   <= fused_admm.SMEM_PER_CTA for n, m in taken), prec


def test_cluster_smem_bytes_by_precision():
    """The hand count in csrc/admm_chunk_cluster.cu's header at 512/256:
    211,136 bytes a CTA at "highest" and "default" (t and xx exchanged as
    one float an element), 217,280 at "high" (their (vh, vl) pairs: two
    more floats a t and an xx element, twice), whatever the G source."""
    assert fused_admm.cluster_smem_bytes(512, 256) == 211_136
    assert fused_admm.cluster_smem_bytes(512, 256, "default") == 211_136
    assert fused_admm.cluster_smem_bytes(512, 256, "high") == 217_280 == (
        211_136 + 4 * 2 * (256 + 512))


# (n, m, smem_bytes) -> whether the lane fits the cluster (ops/cluster.py).
FITS = {
    (512, 256, 1000): True,                  # both headlines
    (128, 128, 1000): True,
    (256, 512, 1000): True,                  # (n/128)(m/128) = 8
    (512, 512, 1000): False,                 # 16 > 8
    (640, 128, 1000): False,                 # n over 512
    (512, 0, 1000): False,
    (500, 256, 1000): False,                 # not a multiple of 128
    (512, 256, cluster.SMEM_PER_CTA): True,  # exactly a CTA's shared memory
    (512, 256, cluster.SMEM_PER_CTA + 4): False,
}


@pytest.mark.parametrize("case", list(FITS), ids=lambda c: ",".join(map(str, c)))
def test_cluster_fits(case):
    """The one register and shared-memory rule both cluster chunks share;
    shared memory is asked for only where the registers fit."""
    n, m, smem = case
    asked = []
    assert cluster.fits(n, m, lambda: asked.append(1) or smem) is FITS[case]
    assert bool(asked) == (FITS[case] or smem > cluster.SMEM_PER_CTA)


def test_both_families_take_the_cluster_rule_from_one_module():
    """Over every 128-multiple shape up to 1024 (and 64-multiples for the
    prox split), each family's chunk_kernel at every precision says
    "cluster" exactly where ``cluster.fits`` takes the shape with the
    family's own shared memory at that precision."""
    assert fused_admm.CLUSTER == fused_proxqp.CLUSTER == cluster.CLUSTER == 8
    for prec in ("highest", "high", "default"):
        for n in range(128, 1025, 128):
            for m in range(128, 1025, 128):
                admm = cluster.fits(
                    n, m, lambda: fused_admm.cluster_smem_bytes(n, m, prec))
                assert (fused_admm.chunk_kernel(n, m, 1, prec, "G")
                        == ("cluster" if admm else "stream")), (prec, n, m)
                for me in range(64, m, 64):
                    prox = cluster.fits(n, m, lambda: fused_proxqp.cluster_smem_bytes(
                        n, me, m - me, prec))
                    assert (fused_proxqp.chunk_kernel(n, me, m - me, 1, prec)
                            == ("cluster" if prox else "stream")), (prec, n, me)


VARIANT_KEYS = {
    (512, 256, 1, "highest", "G"): "highest,G,lanes1,cluster",
    (512, 256, 1, "highest", "slab"): "highest,slab,lanes1,cluster",
    (512, 256, 2, "high", "slab"): "high,slab,lanes2,cluster",
    (512, 256, 4, "highest", "slab"): "highest,slab,lanes4,cluster",
    (512, 256, 2, "high", "split"): "high,split,lanes2,cluster",
    (512, 256, 2, "default", "slab"): "default,slab,lanes2,cluster",
    (1024, 512, 1, "highest", "G"): "highest,G,lanes1",
    (640, 128, 2, "high", "slab"): "high,slab,lanes2",
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


@pytest.mark.parametrize("variant", ["high", "default", "split", "high,slab",
                                     "default,slab"])
def test_cluster_wrapper_precisions_are_the_plain_version_on_cpu(variant):
    """The cluster wrapper at "high" and "default", from G, the slab window
    or the bf16 halves, runs on the CPU the plain version of the variant the
    dispatching chunk runs at lanes 2, bit for bit; the frozen lane passes
    through."""
    qp, G, g, x, z, y, rho_row, active = _chunk_case()
    prec, _, src = variant.partition(",")
    kw = dict(K=3, alpha=1.6, dot_precision="high" if prec == "split" else prec)
    G = _t(G)
    if prec == "split":
        G, kw["Glo"] = linalg.bf16_split(G)
    if src == "slab":
        G = torch.cat([G, torch.ones_like(G)], dim=-1)
        kw["slab"] = True
    vecs = (_t(g), *(_t(v) for v in (qp.l, qp.u, x, z, y, rho_row)),
            torch.from_numpy(active))
    out = fused_admm.fused_admm_chunk_cluster(G, _t(qp.A), *vecs, **kw)
    ref = fused_admm.fused_admm_chunk(G, _t(qp.A), *vecs, lanes=2, **kw)
    plain = fused_admm.fused_admm_chunk_plain(G, _t(qp.A), *vecs, **kw)
    for o, r, p in zip(out, ref, plain):
        assert torch.equal(o, r) and torch.equal(o, p)
    assert torch.equal(out[0][3], vecs[3][3])


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
            "qps_admm_chunk", "qps_admm_chunk_cluster", "qps_prox_chunk",
            "qps_prox_chunk_cluster", "qps_ell_matvec",
            "qps_ell_matvec_prev", "qps_slab_build", "qps_slab_build_prev",
            "qps_slab_level", "qps_slab_level_strip",
            "qps_admm_chunk_minv_cluster", "qps_prox_chunk_minv_cluster",
            "qps_admm_chunk_minv_cluster_occupancy",
            "qps_prox_chunk_minv_cluster_occupancy"} <= set(entries)
    assert entries == {k: len(v) for k, v in _build._SIGNATURES.items()}


# -- row 5a: the prox sigma-free chunk --

#: The shared memory a CTA of the prox cluster chunk needs at the headline
#: shape (n=512, me = mi = 128).
PROX_SMEM = 4 * (16 + 64 * 256 + 32 * 512 + 2 * (256 + 512) + 64 + 3 * 32)

# (n, me, mi, lanes, dot_precision, shared memory a CTA) -> the kernel the
# prox rule picks.
PROX_RULE = {
    (512, 128, 128, 1, "highest", None): "cluster",    # the prox headline
    (512, 128, 128, 1, "highest", PROX_SMEM): "cluster",
    (512, 128, 128, 1, "highest", PROX_SMEM - 4): "stream",
    (128, 64, 64, 1, "highest", None): "cluster",
    (512, 64, 192, 1, "highest", None): "cluster",     # A rows in CTAs 0-1
    (128, 32, 96, 1, "highest", None): "cluster",      # the A/C boundary in a CTA
    (256, 128, 256, 1, "highest", None): "cluster",    # 8 (n/128)(mt/128) = 48
    (384, 128, 128, 1, "highest", None): "cluster",
    (512, 128, 128, 2, "highest", None): "cluster",    # lanes 2: one lane a cluster
    (512, 128, 128, 4, "highest", None): "cluster",
    (512, 128, 128, 1, "high", None): "cluster",       # bf16x3
    (512, 128, 128, 1, "default", None): "cluster",    # one bf16 pass
    (512, 128, 128, 2, "high", None): "cluster",       # the --headline stack
    (512, 128, 128, 2, "default", None): "cluster",    # its first chunk
    (512, 128, 128, 8, "high", None): "cluster",
    (512, 128, 128, 1, "high", PROX_SMEM): "stream",   # holds "highest", not "high"
    (512, 128, 128, 2, "default", PROX_SMEM): "stream",  # nor "default"'s x rows
    (512, 256, 256, 1, "highest", None): "stream",     # over the registers
    (512, 256, 256, 2, "high", None): "stream",
    (384, 128, 256, 1, "highest", None): "stream",     # 3 x 3 > 8
    (640, 64, 64, 1, "highest", None): "stream",       # n over 512
    (640, 64, 64, 4, "default", None): "stream",
    (256, 64, 32, 1, "highest", None): "stream",       # me + mi not 128k
    (500, 128, 128, 1, "highest", None): "stream",     # n not 128k
    (500, 128, 128, 2, "high", None): "stream",
}


@pytest.mark.parametrize("case", list(PROX_RULE), ids=lambda c: ",".join(map(str, c)))
def test_prox_chunk_kernel_rule(case):
    *shape, smem = case
    kw = {} if smem is None else {"smem_per_cta": smem}
    assert fused_proxqp.chunk_kernel(*shape, **kw) == PROX_RULE[case]


def test_prox_cluster_smem_bytes():
    """4 mbarriers (16 floats), the next lane's 64 G rows of 256 and 32
    stacked rows of 512, t and x twice, 64 rows of g and 3 x 32 stacked
    vector rows; every (n, me + mi) the rule takes fits a CTA, and only the
    sum me + mi counts."""
    assert fused_proxqp.cluster_smem_bytes(512, 128, 128) == PROX_SMEM
    assert (fused_proxqp.cluster_smem_bytes(512, 64, 192)
            == fused_proxqp.cluster_smem_bytes(512, 128, 128))
    for prec in ("highest", "high", "default"):
        taken = [(n, mt) for n in range(128, 1025, 128)
                 for mt in range(128, 1025, 128)
                 if fused_proxqp.chunk_kernel(n, mt // 2, mt // 2, 1, prec) == "cluster"]
        assert len(taken) == 12, prec
        assert all(fused_proxqp.cluster_smem_bytes(n, mt // 2, mt // 2, prec)
                   <= fused_admm.SMEM_PER_CTA for n, mt in taken), prec


def test_prox_cluster_smem_bytes_by_precision():
    """The hand count in csrc/prox_chunk_cluster.cu's header at n=512,
    me = mi = 128: 137,920 bytes a CTA at "highest", 138,176 at "default"
    (the CTA's 64 rows of the f32 x besides the bf16 exchanges), 144,320
    at "high" (t's and x's (vh, vl) pairs, twice, and the 64 x rows)."""
    assert fused_proxqp.cluster_smem_bytes(512, 128, 128) == 137_920 == PROX_SMEM
    assert fused_proxqp.cluster_smem_bytes(512, 128, 128, "default") == 138_176 == (
        PROX_SMEM + 4 * 64)
    assert fused_proxqp.cluster_smem_bytes(512, 128, 128, "high") == 144_320 == (
        PROX_SMEM + 4 * (2 * (256 + 512) + 64))


PROX_VARIANT_KEYS = {
    (512, 128, 128, 1, "highest"): "highest,lanes1,cluster",
    (128, 32, 96, 1, "highest"): "highest,lanes1,cluster",
    (512, 128, 128, 2, "high"): "high,lanes2,cluster",
    (512, 128, 128, 2, "default"): "default,lanes2,cluster",
    (512, 128, 128, 1, "high"): "high,lanes1,cluster",
    (512, 128, 128, 2, "highest"): "highest,lanes2,cluster",
    (1024, 256, 256, 1, "highest"): "highest,lanes1",
    (640, 64, 64, 2, "high"): "high,lanes2",
}


@pytest.mark.parametrize("case", list(PROX_VARIANT_KEYS),
                         ids=lambda c: ",".join(map(str, c)))
def test_prox_chunk_variant_key(case):
    assert fused_proxqp.chunk_variant(*case) == PROX_VARIANT_KEYS[case]


def test_prox_cluster_wrapper_refuses_what_the_rule_sends_elsewhere():
    B = 2
    for n, me, mi in ((1024, 256, 256), (512, 64, 32), (640, 64, 64)):
        mt = me + mi
        z = [torch.zeros((B, w)) for w in (n, me, mi, n, mi, me, mi)]
        with pytest.raises(ValueError, match="do not fit a cluster of 8 CTAs"):
            fused_proxqp.fused_proxqp_chunk_cluster(
                torch.zeros((B, n, mt)), torch.zeros((B, me, n)),
                torch.zeros((B, mi, n)), *z, torch.ones(B),
                torch.ones(B, dtype=torch.bool), K=1)


class _Ref:
    """A Pallas ref stand-in for calling a kernel body eagerly: reads index
    the array, writes replace it with ``.at[idx].set``."""

    def __init__(self, value):
        self.value = value

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, v):
        self.value = self.value.at[idx].set(v)


PROX_B, PROX_N, PROX_ME, PROX_MI, PROX_K = 4, 128, 64, 64, 5


@pytest.fixture(scope="module")
def prox_case():
    """A split-form fleet at n=128, me = mi = 64 (a cluster CTA holds 16
    stacked rows there: CTAs 0-3 the A rows, 4-7 the C rows), its sigma-free
    cache G = M^{-1}[A' C'] and g in f64, rounded
    to float32, iterates with the last lane frozen, and JAX's kernel body
    (ops/fused_proxqp.py: _chunk_kernel, sigma-free) run eagerly on them,
    all lanes in one call. JAX's wrapper takes only 128-multiple me and mi,
    so the body is called through a ref shim with program_id 0."""
    B, n, me, mi = PROX_B, PROX_N, PROX_ME, PROX_MI
    rng = np.random.default_rng(11)
    M = rng.standard_normal((B, n, n))
    P = np.swapaxes(M, 1, 2) @ M / n + np.eye(n)
    A = rng.standard_normal((B, me, n))
    C = rng.standard_normal((B, mi, n))
    xf = rng.standard_normal((B, n))
    q = rng.standard_normal((B, n))
    b = np.einsum("bij,bj->bi", A, xf)
    d = np.einsum("bij,bj->bi", C, xf) + 1.0
    rho = rng.uniform(0.05, 0.5, B)
    Mn = P + rho[:, None, None] * (np.swapaxes(A, 1, 2) @ A + np.swapaxes(C, 1, 2) @ C)
    X = np.linalg.solve(Mn, np.concatenate(
        [np.swapaxes(A, 1, 2), np.swapaxes(C, 1, 2), q[:, :, None]], axis=-1))
    G, g = X[..., :me + mi], X[..., me + mi]
    x = rng.standard_normal((B, n))
    s = np.abs(rng.standard_normal((B, mi)))
    y = rng.standard_normal((B, me))
    z = np.abs(rng.standard_normal((B, mi)))
    arrs = [a.astype(np.float32) for a in (G, A, C, g, b, d, x, s, y, z, rho)]
    active = np.array([True, True, True, False])
    G, A, C, g, b, d, x, s, y, z, rho = arrs
    vec = lambda a: _Ref(jnp.asarray(a)[:, None, :])  # noqa: E731
    outs = [_Ref(jnp.zeros((B, 1, w), jnp.float32)) for w in (n, mi, me, mi)]
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jax_fused_proxqp.pl, "program_id", lambda axis: 0)
        jax_fused_proxqp._chunk_kernel(
            _Ref(jnp.asarray(rho)), _Ref(jnp.asarray(active.astype(np.int32))),
            _Ref(jnp.asarray(G[..., :me])), _Ref(jnp.asarray(A)),
            _Ref(jnp.asarray(C)), _Ref(jnp.asarray(G[..., me:])), vec(g),
            vec(b), vec(d), vec(x), vec(s), vec(y), vec(z), *outs, K=PROX_K,
            sigma=0.0, refine=0, lanes=B, sigma_free=True)
    ref = [np.asarray(o.value)[:, 0] for o in outs]
    return [torch.from_numpy(a) for a in arrs], torch.from_numpy(active), ref


@pytest.mark.parametrize("wrapper", ["fused_proxqp_chunk_cluster",
                                     "fused_proxqp_chunk_streaming",
                                     "fused_proxqp_chunk"])
def test_prox_one_kernel_wrappers_match_jax_on_cpu(prox_case, wrapper):
    """The cluster and streaming wrappers and the dispatching chunk run the
    plain version on the CPU: bit for bit it, within 1e-5 of each output's
    max of JAX's kernel body, the frozen lane passed through."""
    args, active, ref = prox_case
    out = getattr(fused_proxqp, wrapper)(*args, active, K=PROX_K)
    plain = fused_proxqp.fused_proxqp_chunk_plain(*args, active, K=PROX_K)
    for name, o, p, r, v0 in zip("xsyz", out, plain, ref, args[6:10]):
        assert torch.equal(o, p), name
        assert np.abs(o.numpy() - r).max() <= 1e-5 * max(np.abs(r).max(), 1.0), name
        assert torch.equal(o[~active], v0[~active]), name
    assert not torch.equal(out[0][active], args[6][active])


@pytest.mark.parametrize("prec", ["high", "default"])
def test_prox_cluster_wrapper_precisions_are_the_plain_version_on_cpu(prox_case, prec):
    """The prox cluster wrapper at "high" and "default" runs on the CPU the
    plain version the dispatching chunk runs at lanes 2, bit for bit, the
    frozen lane passed through, and differs from "highest"."""
    args, active, _ = prox_case
    out = fused_proxqp.fused_proxqp_chunk_cluster(*args, active, K=PROX_K,
                                                  dot_precision=prec)
    ref = fused_proxqp.fused_proxqp_chunk(*args, active, K=PROX_K, lanes=2,
                                          dot_precision=prec)
    plain = fused_proxqp.fused_proxqp_chunk_plain(*args, active, K=PROX_K,
                                                  dot_precision=prec)
    top = fused_proxqp.fused_proxqp_chunk_plain(*args, active, K=PROX_K)
    for name, o, r, p, v0 in zip("xsyz", out, ref, plain, args[6:10]):
        assert torch.equal(o, r) and torch.equal(o, p), name
        assert torch.equal(o[~active], v0[~active]), name
    assert not torch.equal(out[0], top[0])
