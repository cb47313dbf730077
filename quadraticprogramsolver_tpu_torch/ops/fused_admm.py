"""Fused ADMM chunks: K iterations per active lane in one launch.

Counterpart of ``quadraticprogramsolver_tpu/ops/fused_admm.py``
(``fused_admm_chunk``) in every variant the solver reaches:

- :func:`fused_admm_chunk`, the sigma-free form, with ``lanes`` lanes per
  CTA; G contiguous, as a window of the factor's slab (``slab=True``,
  Settings.slab_cache) or as two bf16 halves (``Glo``, Settings.split_cache);
  iterate products at ``dot_precision`` "highest" (FP32), "high" (bf16x3)
  or "default" (one bf16 pass, the check products included);
- :func:`fused_admm_chunk_minv`, the M^{-1} form with ``refine`` refinement
  passes, with ``lanes``.

On a CUDA tensor each wrapper launches its kernel in csrc/admm_chunk.cu; on
a CPU tensor it runs its plain version, which rounds to bf16 only float32
operands (float64 runs in full, as the JAX package's f64 solve does) and
runs any lane grouping as lanes=1 (the kernels give the same bits).

A sigma-free launch whose lane fits a cluster (:func:`chunk_kernel`), at
any ``lanes``, precision and G source, runs the cluster kernel,
csrc/admm_chunk_cluster.cu, which holds each lane's G and A in the
registers of a cluster of :data:`CLUSTER` CTAs for all K iterations (one
lane a cluster: ``lanes`` changes no bit, so it changes no kernel); the
other shapes stream them (admm_chunk.cu). Both give the same bits.
:func:`fused_admm_chunk_streaming` and :func:`fused_admm_chunk_cluster`
launch one kernel whatever the rule says (each other's witness on the card).

An M^{-1}-form launch whose lane fits a cluster, at any ``lanes``
(:func:`minv_chunk_kernel`), runs csrc/admm_chunk_minv_cluster.cu, which
holds each lane's M^{-1} and A rows in a cluster's registers and A's
columns and P's rows in its shared memory for all K iterations; other
shapes stream them (admm_chunk.cu: admm_chunk_minv_kernel). Both give the
same bits; :func:`fused_admm_chunk_minv_streaming` and
:func:`fused_admm_chunk_minv_cluster` are the one-kernel witnesses.
"""

from __future__ import annotations

import collections

import torch

from .. import _build
from .cluster import CLUSTER, SMEM_PER_CTA, fits
from .linalg import (PRECISIONS, bf16_round, dot_operand, matvec, matvec_at,
                     resolve_precision)


def _check_sigma_free(G, Glo, B, m, lanes, dot_precision, slab):
    """The JAX wrapper's checks of a sigma-free variant (ValueError)."""
    if dot_precision not in PRECISIONS:
        raise ValueError(f"dot_precision must be one of {tuple(PRECISIONS)}; "
                         f"got {dot_precision!r}")
    if lanes < 1 or B % lanes:
        raise ValueError(f"batch {B} not divisible by lanes={lanes}")
    if Glo is not None and (slab or dot_precision != "high"):
        raise ValueError("a pre-split G (Glo) requires sigma_free + "
                         "dot_precision='high' and excludes slab")
    if Glo is not None and (G.dtype != torch.bfloat16
                            or Glo.dtype != torch.bfloat16):
        raise ValueError("pre-split G halves must be bfloat16")
    if slab and G.shape[-1] < m:
        raise ValueError(f"slab width {G.shape[-1]} < m={m}")
    if not slab and G.shape[-1] != m:
        raise ValueError(f"G must be (B, n, m); got {tuple(G.shape)} "
                         "(pass slab=True for a slab-backed G)")


def fused_admm_chunk_plain(G, A, g, l, u, x, z, y, rho_row, active, *,
                           K: int, alpha: float, lanes: int = 1,
                           dot_precision: str = "highest", slab: bool = False,
                           Glo=None):
    """Plain PyTorch chunk; same arguments and outputs as
    :func:`fused_admm_chunk`. Any float dtype and device."""
    m = l.shape[-1]
    _check_sigma_free(G, Glo, x.shape[0], m, lanes, dot_precision, slab)
    prec = resolve_precision(dot_precision, x.dtype)
    if Glo is not None:
        halves = (G.to(x.dtype), Glo.to(x.dtype))
        Gop = halves if prec == "high" else (halves[0] + halves[1],)
    else:
        Gop = dot_operand(G[..., :m].contiguous() if slab else G, prec)
    return _plain_chunk(lambda x, z, y: matvec_at(Gop, rho_row * z - y, prec) - g,
                        A, l, u, x, z, y, rho_row, active, K=K, alpha=alpha,
                        precision=prec)


def _plain_chunk(kkt_solve, A, l, u, x, z, y, rho_row, active, *, K, alpha,
                 precision="highest"):
    """K masked ADMM iterations around ``kkt_solve(x, z, y) -> xx``; zz = A xx
    at ``precision``, and the check products at one bf16 pass when it is
    "default", else in full."""
    act = active.bool()[:, None]
    rho_inv = 1.0 / rho_row
    Aop = dot_operand(A, precision)
    x0, z0, y0 = x, z, y
    xp, zp = x, z
    for _ in range(K):
        xx = kkt_solve(x, z, y)
        zz = matvec_at(Aop, xx, precision)
        xp, zp = x, z
        x = alpha * xx + (1.0 - alpha) * xp
        zr = alpha * zz + (1.0 - alpha) * zp
        z = torch.minimum(torch.maximum(zr + rho_inv * y, l), u)
        y = y + rho_row * (zr - z)
    x = torch.where(act, x, x0)
    z = torch.where(act, z, z0)
    y = torch.where(act, y, y0)
    xp = torch.where(act, xp, x0)
    zp = torch.where(act, zp, z0)
    if precision == "default":
        Ab, xc, yc = Aop[0], bf16_round(x), bf16_round(y)
    else:
        Ab, xc, yc = A, x, y
    Ax = matvec(Ab, xc)
    ATy = torch.matmul(yc.unsqueeze(-2), Ab).squeeze(-2)
    return x, z, y, xp, zp, Ax, ATy


def cluster_smem_bytes(n: int, m: int, dot_precision: str = "highest") -> int:
    """Shared memory one CTA of the cluster chunk needs at (n, m) and
    ``dot_precision`` (the split source holds what "high" holds): the next
    lane's n/8 rows of G and m/8 rows of A and this lane's n/8 columns of A,
    t and xx twice in their exchange form (two floats an element at
    "high"), the x and y gathers twice, its own vector rows, A'y's partial
    sums and four mbarriers (csrc/admm_chunk_cluster.cu: cluster_floats)."""
    nr, mr = n // CLUSTER, m // CLUSTER
    groups = 256 // (n // 4)
    width = 2 if dot_precision == "high" else 1
    return 4 * (16 + 3 * nr * m + 2 * width * (m + n) + 2 * (m + n) + 3 * nr
                + 7 * mr + groups * nr)


def chunk_kernel(n: int, m: int, lanes: int, dot_precision: str, source: str,
                 smem_per_cta: int = SMEM_PER_CTA) -> str:
    """The kernel a sigma-free chunk launch runs: "cluster" (one lane per
    cluster of :data:`CLUSTER` CTAs, G and A held in registers, the next
    lane's rows loaded into shared memory meanwhile) at every
    ``dot_precision`` ("highest", "high", "default"), G ``source`` ("G"
    contiguous, "slab" the window, "split" the bf16 halves) and ``lanes``
    (ignored: one lane a cluster, and the outputs do not depend on it),
    when the lane fits the cluster (:func:`.cluster.fits`: n and m
    multiples of 128 up to 512 with (n/128)(m/128) <= 8, and
    :func:`cluster_smem_bytes` at ``dot_precision`` within
    ``smem_per_cta``); else "stream" (admm_chunk.cu, the matrices read
    from device memory every iteration)."""
    if (dot_precision in PRECISIONS and source in ("G", "slab", "split")
            and fits(n, m, lambda: cluster_smem_bytes(n, m, dot_precision),
                     smem_per_cta)):
        return "cluster"
    return "stream"


def chunk_variant(n: int, m: int, lanes: int, dot_precision: str,
                  source: str) -> str:
    """The key a sigma-free launch counts under in
    ``fused_admm_chunk.variants``: "precision,source,lanesL", with
    ",cluster" when :func:`chunk_kernel` sends it to the cluster kernel."""
    key = f"{dot_precision},{source},lanes{lanes}"
    if chunk_kernel(n, m, lanes, dot_precision, source) == "cluster":
        key += ",cluster"
    return key


def _launch_sigma_free(wrapper, kernel, G, A, g, l, u, x, z, y, rho_row,
                       active, *, K, alpha, lanes, dot_precision, slab, Glo,
                       variant=None):
    """Check a sigma-free chunk's operands and launch ``kernel`` ("stream"
    or "cluster"), counted on ``wrapper``; returns the seven outputs."""
    B, n = x.shape
    m = l.shape[-1]
    _check_sigma_free(G, Glo, B, m, lanes, dot_precision, slab)
    if K < 1:
        raise ValueError(f"{wrapper.__name__}: K must be >= 1; got {K}")
    split = Glo is not None
    outs = [torch.empty_like(v) for v in (x, z, y, x, z, z, x)]
    operands = {"G": (G, (B, n, m)), "A": (A, (B, m, n)), "g": (g, (B, n)),
                "l": (l, (B, m)), "u": (u, (B, m)), "x": (x, (B, n)),
                "z": (z, (B, m)), "y": (y, (B, m)),
                "rho_row": (rho_row, (B, m))}
    if split:
        operands["Glo"] = (Glo, (B, n, m))
    act = _build.check_chunk(
        wrapper.__name__, operands, {"n": n, "m": m}, outs, active,
        bf16=("G", "Glo") if split else (), windows=("G",) if slab else ())
    vecs = (A.data_ptr(), g.data_ptr(), l.data_ptr(), u.data_ptr(),
            rho_row.data_ptr(), x.data_ptr(), z.data_ptr(), y.data_ptr(),
            act.data_ptr(), *(o.data_ptr() for o in outs))
    ptrs = (None if split else G.data_ptr(), G.data_ptr() if split else None,
            Glo.data_ptr() if split else None, *vecs, B, n, m, G.shape[-1], K)
    if kernel == "cluster":
        _build.launch(wrapper, "qps_admm_chunk_cluster", *ptrs,
                      PRECISIONS[dot_precision], float(alpha),
                      _build.stream_ptr(x), variant=variant)
    else:
        _build.launch(wrapper, "qps_admm_chunk", *ptrs, lanes,
                      PRECISIONS[dot_precision], float(alpha),
                      _build.stream_ptr(x), variant=variant)
    return tuple(outs)


def fused_admm_chunk(G, A, g, l, u, x, z, y, rho_row, active, *,
                     K: int, alpha: float, lanes: int = 1,
                     dot_precision: str = "highest", slab: bool = False,
                     Glo=None):
    """Run K sigma-free ADMM iterations for every active lane.

    G (B, n, m) = M^{-1}A', A (B, m, n), g (B, n) = M^{-1}q, l/u/z/y/rho_row
    (B, m), x (B, n), active (B,) bool. ``lanes`` lanes per CTA (B must
    divide). ``slab``: G is the factor's whole slab (B, n, W >= m), read as
    the window of its first m columns. ``Glo``: G is the bf16 high half and
    Glo the low half (dot_precision "high" only, no slab). ``dot_precision``
    of G t and A xx: "highest", "high" (bf16x3; the check products in
    full) or "default" (one bf16 pass, the check products too). Returns
    (x, z, y, x_prev, z_prev, Ax, ATy): prev is the iterate at the start of
    the last iteration; frozen lanes pass through with prev = current; Ax
    and A'y are the check products of the returned x and y, computed for
    frozen lanes too.

    On a CUDA tensor the launch runs the kernel :func:`chunk_kernel` names
    and counts under its :func:`chunk_variant` key, e.g.
    "high,slab,lanes2,cluster" or "highest,G,lanes1" (a lane that does not
    fit a cluster).
    """
    if not _build.launches_kernel("fused_admm_chunk", x):
        return fused_admm_chunk_plain(G, A, g, l, u, x, z, y, rho_row, active,
                                      K=K, alpha=alpha, lanes=lanes,
                                      dot_precision=dot_precision, slab=slab,
                                      Glo=Glo)
    n, m = x.shape[-1], l.shape[-1]
    source = "split" if Glo is not None else "slab" if slab else "G"
    return _launch_sigma_free(
        fused_admm_chunk, chunk_kernel(n, m, lanes, dot_precision, source),
        G, A, g, l, u, x, z, y, rho_row, active, K=K, alpha=alpha, lanes=lanes,
        dot_precision=dot_precision, slab=slab, Glo=Glo,
        variant=chunk_variant(n, m, lanes, dot_precision, source))


fused_admm_chunk.launches = 0
fused_admm_chunk.variants = collections.Counter()


def fused_admm_chunk_streaming(G, A, g, l, u, x, z, y, rho_row, active, *,
                               K: int, alpha: float, lanes: int = 1,
                               dot_precision: str = "highest",
                               slab: bool = False, Glo=None):
    """:func:`fused_admm_chunk` through the streaming kernel (admm_chunk.cu)
    in every variant, whatever :func:`chunk_kernel` says: the cluster
    kernel's bit-for-bit witness and timing baseline on the card (no solver
    calls it). Counts on its own ``launches``; on a CPU tensor the plain
    version."""
    if not _build.launches_kernel("fused_admm_chunk_streaming", x):
        return fused_admm_chunk_plain(G, A, g, l, u, x, z, y, rho_row, active,
                                      K=K, alpha=alpha, lanes=lanes,
                                      dot_precision=dot_precision, slab=slab,
                                      Glo=Glo)
    return _launch_sigma_free(
        fused_admm_chunk_streaming, "stream", G, A, g, l, u, x, z, y, rho_row,
        active, K=K, alpha=alpha, lanes=lanes, dot_precision=dot_precision,
        slab=slab, Glo=Glo)


fused_admm_chunk_streaming.launches = 0


def fused_admm_chunk_cluster(G, A, g, l, u, x, z, y, rho_row, active, *,
                             K: int, alpha: float,
                             dot_precision: str = "highest",
                             slab: bool = False, Glo=None):
    """:func:`fused_admm_chunk` through the cluster kernel
    (csrc/admm_chunk_cluster.cu) at ``dot_precision`` from any G source,
    whatever the solver's rule would pick (it takes no ``lanes``: one lane
    a cluster). Raises ValueError where :func:`chunk_kernel` refuses the
    shape. Counts on its own ``launches``; on a CPU tensor the plain
    version."""
    n, m = x.shape[-1], l.shape[-1]
    source = "split" if Glo is not None else "slab" if slab else "G"
    if chunk_kernel(n, m, 1, dot_precision, source) != "cluster":
        raise ValueError(f"fused_admm_chunk_cluster: n={n}, m={m} do not fit "
                         f"a cluster of {CLUSTER} CTAs at {dot_precision!r}")
    if not _build.launches_kernel("fused_admm_chunk_cluster", x):
        return fused_admm_chunk_plain(G, A, g, l, u, x, z, y, rho_row, active,
                                      K=K, alpha=alpha,
                                      dot_precision=dot_precision, slab=slab,
                                      Glo=Glo)
    return _launch_sigma_free(
        fused_admm_chunk_cluster, "cluster", G, A, g, l, u, x, z, y, rho_row,
        active, K=K, alpha=alpha, lanes=1, dot_precision=dot_precision,
        slab=slab, Glo=Glo)


fused_admm_chunk_cluster.launches = 0


def cluster_occupancy(n: int, m: int, dot_precision: str = "highest") -> int:
    """How many clusters of the cluster chunk at (n, m) and
    ``dot_precision`` the current card holds at once
    (cudaOccupancyMaxActiveClusters): the lanes in flight, and the clusters
    a launch starts (each walks B / that many lanes)."""
    import ctypes

    out = ctypes.c_int(0)
    _build.check(_build.load().lib.qps_admm_chunk_cluster_occupancy(
        n, m, PRECISIONS[dot_precision], ctypes.byref(out)),
        "qps_admm_chunk_cluster_occupancy")
    return out.value


def fused_admm_chunk_minv_plain(Minv, A, P, q, l, u, x, z, y, rho_row, active,
                                *, K: int, alpha: float, sigma: float,
                                refine: int, lanes: int = 1):
    """Plain PyTorch M^{-1}-form chunk; same arguments and outputs as
    :func:`fused_admm_chunk_minv`. Any float dtype and device."""
    if lanes < 1 or x.shape[0] % lanes:
        raise ValueError(f"batch {x.shape[0]} not divisible by lanes={lanes}")
    At = A.transpose(-1, -2)

    def kkt_solve(x, z, y):
        rhs = sigma * x - q + matvec(At, rho_row * z - y)
        xx = matvec(Minv, rhs)
        for _ in range(refine):
            Mxx = matvec(P, xx) + sigma * xx + matvec(At, rho_row * matvec(A, xx))
            xx = xx + matvec(Minv, rhs - Mxx)
        return xx

    return _plain_chunk(kkt_solve, A, l, u, x, z, y, rho_row, active, K=K,
                        alpha=alpha)


def minv_cluster_smem_bytes(n: int, m: int, refine: int) -> int:
    """Shared memory one CTA of the M^{-1}-form cluster chunk needs at (n, m):
    five mbarriers, the exchange buffers t, rho A xx (m each), rhs, xx and
    the residual (n each), the x and y gathers twice, its vector rows, the
    A' products' partial sums, this lane's m x n/8 columns of A and, when
    ``refine`` > 0, its n/8 x n rows of P
    (csrc/admm_chunk_minv_cluster.cu: minv_cluster_floats)."""
    nr, mr = n // CLUSTER, m // CLUSTER
    groups = 256 // (n // 4)
    return 4 * (16 + 2 * m + 3 * n + 2 * (n + m) + 6 * nr + 7 * mr
                + groups * nr + m * nr + (nr * n if refine > 0 else 0))


def minv_chunk_kernel(n: int, m: int, lanes: int, refine: int,
                      smem_per_cta: int = SMEM_PER_CTA) -> str:
    """The kernel an M^{-1}-form chunk launch runs: "cluster" (one lane per
    cluster of :data:`CLUSTER` CTAs, M^{-1} and A rows in registers, A's
    columns and, with refinement, P's rows in shared memory, for all K
    iterations) at any ``lanes`` (ignored: one lane a cluster) when the
    lane fits the cluster
    (:func:`.cluster.fits` at (n, m), whose register rule keeps a thread's
    4 (n/128)(n/128 + m/128) floats of M^{-1} and A rows within 96, and
    :func:`minv_cluster_smem_bytes` within ``smem_per_cta``); else "stream"
    (admm_chunk.cu: admm_chunk_minv_kernel, every matrix read from device
    memory each time it is used)."""
    if fits(n, m, lambda: minv_cluster_smem_bytes(n, m, refine), smem_per_cta):
        return "cluster"
    return "stream"


def minv_chunk_variant(n: int, m: int, lanes: int, refine: int) -> str:
    """The key an M^{-1}-form launch counts under in
    ``fused_admm_chunk_minv.variants``: "lanesL", with ",cluster" when
    :func:`minv_chunk_kernel` sends it to the cluster kernel."""
    key = f"lanes{lanes}"
    if minv_chunk_kernel(n, m, lanes, refine) == "cluster":
        key += ",cluster"
    return key


def _launch_minv(wrapper, kernel, Minv, A, P, q, l, u, x, z, y, rho_row,
                 active, *, K, alpha, sigma, refine, lanes, variant=None):
    """Check an M^{-1}-form chunk's operands and launch ``kernel``
    ("stream" or "cluster"), counted on ``wrapper``; returns the seven
    outputs."""
    B, n = x.shape
    m = l.shape[-1]
    name = wrapper.__name__
    if K < 1 or refine < 0 or lanes < 1 or B % lanes:
        raise ValueError(f"{name}: K must be >= 1, refine >= 0 and lanes "
                         f"must divide B={B}; got K={K}, refine={refine}, "
                         f"lanes={lanes}")
    operands = {"Minv": (Minv, (B, n, n)), "A": (A, (B, m, n)),
                "q": (q, (B, n)), "l": (l, (B, m)), "u": (u, (B, m)),
                "x": (x, (B, n)), "z": (z, (B, m)), "y": (y, (B, m)),
                "rho_row": (rho_row, (B, m))}
    if refine > 0:
        operands["P"] = (P, (B, n, n))
    outs = [torch.empty_like(v) for v in (x, z, y, x, z, z, x)]
    act = _build.check_chunk(name, operands, {"n": n, "m": m}, outs, active)
    ptrs = (Minv.data_ptr(), A.data_ptr(),
            P.data_ptr() if refine > 0 else None, q.data_ptr(), l.data_ptr(),
            u.data_ptr(), rho_row.data_ptr(), x.data_ptr(), z.data_ptr(),
            y.data_ptr(), act.data_ptr(), *(o.data_ptr() for o in outs))
    if kernel == "cluster":
        _build.launch(wrapper, "qps_admm_chunk_minv_cluster", *ptrs, B, n, m,
                      K, refine, float(alpha), float(sigma),
                      _build.stream_ptr(x), variant=variant)
    else:
        _build.launch(wrapper, "qps_admm_chunk_minv", *ptrs, B, n, m, K,
                      refine, lanes, float(alpha), float(sigma),
                      _build.stream_ptr(x), variant=variant)
    return tuple(outs)


def fused_admm_chunk_minv(Minv, A, P, q, l, u, x, z, y, rho_row, active, *,
                          K: int, alpha: float, sigma: float, refine: int,
                          lanes: int = 1):
    """Run K M^{-1}-form ADMM iterations for every active lane.

    Minv (B, n, n) = (P + sigma*I + A' diag(rho_row) A)^{-1} (contracted as
    Minv @ rhs), A (B, m, n), P (B, n, n) (read only when refine > 0; may
    then be None), q/x (B, n), l/u/z/y/rho_row (B, m), active (B,) bool.
    Each KKT solve takes ``refine`` refinement passes against the true M
    built from P and A; ``lanes`` lanes per CTA (B must divide). Returns
    what :func:`fused_admm_chunk` returns.

    On a CUDA tensor the launch runs the kernel :func:`minv_chunk_kernel`
    names and counts under its :func:`minv_chunk_variant` key, e.g.
    "lanes2,cluster" or "lanes1" (a lane that does not fit a cluster).
    """
    if not _build.launches_kernel("fused_admm_chunk_minv", x):
        return fused_admm_chunk_minv_plain(Minv, A, P, q, l, u, x, z, y,
                                           rho_row, active, K=K, alpha=alpha,
                                           sigma=sigma, refine=refine,
                                           lanes=lanes)
    n, m = x.shape[-1], l.shape[-1]
    return _launch_minv(
        fused_admm_chunk_minv, minv_chunk_kernel(n, m, lanes, refine), Minv, A,
        P, q, l, u, x, z, y, rho_row, active, K=K, alpha=alpha, sigma=sigma,
        refine=refine, lanes=lanes,
        variant=minv_chunk_variant(n, m, lanes, refine))


fused_admm_chunk_minv.launches = 0
fused_admm_chunk_minv.variants = collections.Counter()


def fused_admm_chunk_minv_streaming(Minv, A, P, q, l, u, x, z, y, rho_row,
                                    active, *, K: int, alpha: float,
                                    sigma: float, refine: int, lanes: int = 1):
    """:func:`fused_admm_chunk_minv` through the streaming kernel
    (admm_chunk.cu: admm_chunk_minv_kernel) whatever
    :func:`minv_chunk_kernel` says: the cluster kernel's bit-for-bit
    witness and timing baseline on the card (no solver calls it). Counts
    on its own ``launches``; on a CPU tensor the plain version."""
    if not _build.launches_kernel("fused_admm_chunk_minv_streaming", x):
        return fused_admm_chunk_minv_plain(Minv, A, P, q, l, u, x, z, y,
                                           rho_row, active, K=K, alpha=alpha,
                                           sigma=sigma, refine=refine,
                                           lanes=lanes)
    return _launch_minv(
        fused_admm_chunk_minv_streaming, "stream", Minv, A, P, q, l, u, x, z,
        y, rho_row, active, K=K, alpha=alpha, sigma=sigma, refine=refine,
        lanes=lanes)


fused_admm_chunk_minv_streaming.launches = 0


def fused_admm_chunk_minv_cluster(Minv, A, P, q, l, u, x, z, y, rho_row,
                                  active, *, K: int, alpha: float,
                                  sigma: float, refine: int):
    """:func:`fused_admm_chunk_minv` through the cluster kernel
    (csrc/admm_chunk_minv_cluster.cu, one lane a cluster), whatever the
    solver's rule would pick. Raises ValueError where
    :func:`minv_chunk_kernel` refuses the shape. Counts on its own
    ``launches``; on a CPU tensor the plain version."""
    n, m = x.shape[-1], l.shape[-1]
    if minv_chunk_kernel(n, m, 1, refine) != "cluster":
        raise ValueError(f"fused_admm_chunk_minv_cluster: n={n}, m={m}, "
                         f"refine={refine} do not fit a cluster of "
                         f"{CLUSTER} CTAs")
    if not _build.launches_kernel("fused_admm_chunk_minv_cluster", x):
        return fused_admm_chunk_minv_plain(Minv, A, P, q, l, u, x, z, y,
                                           rho_row, active, K=K, alpha=alpha,
                                           sigma=sigma, refine=refine)
    return _launch_minv(
        fused_admm_chunk_minv_cluster, "cluster", Minv, A, P, q, l, u, x, z, y,
        rho_row, active, K=K, alpha=alpha, sigma=sigma, refine=refine,
        lanes=1)


fused_admm_chunk_minv_cluster.launches = 0


def minv_cluster_occupancy(n: int, m: int, refine: int) -> int:
    """How many clusters of the M^{-1}-form cluster chunk at (n, m, refine)
    the current card holds at once (cudaOccupancyMaxActiveClusters): the
    lanes in flight, and the clusters a launch starts."""
    import ctypes

    out = ctypes.c_int(0)
    _build.check(_build.load().lib.qps_admm_chunk_minv_cluster_occupancy(
        n, m, refine, ctypes.byref(out)), "qps_admm_chunk_minv_cluster_occupancy")
    return out.value
