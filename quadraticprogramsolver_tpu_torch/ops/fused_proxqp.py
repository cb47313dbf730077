"""Fused prox-ALM chunks: K iterations per active lane in one launch.

Counterpart of ``quadraticprogramsolver_tpu/ops/fused_proxqp.py``
(``fused_proxqp_chunk``) in every variant the solver reaches:

- :func:`fused_proxqp_chunk`, the sigma-free form, with ``lanes`` lanes per
  CTA and its products G t, C x and A x at ``dot_precision`` "highest"
  (FP32), "high" (bf16x3) or "default" (one bf16 pass). The column cache
  enters as one operand G = [Ga | Gc] (B, n, me + mi), so the x-update is
  one product with the concatenated t = [rho b - y; rho(d - s) - z];
- :func:`fused_proxqp_chunk_minv`, the M^{-1} form with ``refine``
  refinement passes, with ``lanes``.

On a CUDA tensor each wrapper launches its kernel in csrc/prox_chunk.cu; on
a CPU tensor it runs its plain version, which rounds to bf16 only float32
operands and runs any lane grouping as lanes=1 (the kernels give the same
bits).

A sigma-free launch whose lane fits a cluster (:func:`chunk_kernel`), at
any ``lanes`` and precision, runs the cluster kernel,
csrc/prox_chunk_cluster.cu, which holds each lane's G, A and C in the
registers of a cluster of :data:`CLUSTER` CTAs for all K iterations (one
lane a cluster: ``lanes`` changes no bit, so it changes no kernel); the
other shapes stream them (prox_chunk.cu). Both give the same bits.
:func:`fused_proxqp_chunk_streaming` and :func:`fused_proxqp_chunk_cluster`
launch one kernel whatever the rule says (each other's witness on the card).

An M^{-1}-form launch whose lane fits a cluster, at any ``lanes``
(:func:`minv_chunk_kernel`), runs csrc/prox_chunk_minv_cluster.cu (M^{-1}
and [A; C] rows in a cluster's registers, [A; C]'s columns and P's rows in
its shared memory); other shapes stream them (prox_chunk.cu:
prox_chunk_minv_kernel). Both give the same bits;
:func:`fused_proxqp_chunk_minv_streaming` and
:func:`fused_proxqp_chunk_minv_cluster` are the one-kernel witnesses.
"""

from __future__ import annotations

import collections

import torch

from .. import _build
from .cluster import CLUSTER, SMEM_PER_CTA, fits
from .linalg import PRECISIONS, dot_operand, matvec, matvec_at, resolve_precision


def _check_lanes(B, lanes):
    if lanes < 1 or B % lanes:
        raise ValueError(f"batch {B} not divisible by lanes={lanes}")


def fused_proxqp_chunk_plain(G, A, C, g, b, d, x, s, y, z, rho, active, *,
                             K: int, lanes: int = 1,
                             dot_precision: str = "highest"):
    """Plain PyTorch chunk; same arguments and outputs as
    :func:`fused_proxqp_chunk`. Any float dtype, device and batch shape
    (A, C, b and d may be shared across the batch)."""
    if dot_precision not in PRECISIONS:
        raise ValueError(f"dot_precision must be one of {tuple(PRECISIONS)}; "
                         f"got {dot_precision!r}")
    if x.dim() == 2:
        _check_lanes(x.shape[0], lanes)
    prec = resolve_precision(dot_precision, x.dtype)
    r = rho[..., None]
    Gop = dot_operand(G, prec)
    return _plain_chunk(
        lambda x, s, y, z: matvec_at(
            Gop, torch.cat([r * b - y, r * (d - s) - z], dim=-1), prec) - g,
        A, C, b, d, x, s, y, z, rho, active, K=K, precision=prec)


def _plain_chunk(kkt_solve, A, C, b, d, x, s, y, z, rho, active, *, K,
                 precision="highest"):
    """K masked prox-ALM iterations around ``kkt_solve(x, s, y, z) -> x``,
    with C x and A x at ``precision``."""
    act = active.bool()[..., None]
    r = rho[..., None]
    rho_inv = 1.0 / r
    Aop, Cop = dot_operand(A, precision), dot_operand(C, precision)
    x0, s0, y0, z0 = x, s, y, z
    for _ in range(K):
        x = kkt_solve(x, s, y, z)
        Cx = matvec_at(Cop, x, precision)
        Ax = matvec_at(Aop, x, precision)
        s = torch.clamp_min(d - Cx - rho_inv * z, 0.0)
        y = y + r * (Ax - b)
        z = torch.clamp_min(z + r * (Cx - d + s), 0.0)
    return (torch.where(act, x, x0), torch.where(act, s, s0),
            torch.where(act, y, y0), torch.where(act, z, z0))


def cluster_smem_bytes(n: int, me: int, mi: int,
                       dot_precision: str = "highest") -> int:
    """Shared memory one CTA of the prox cluster chunk needs at (n, me, mi)
    and ``dot_precision``: the next lane's n/8 rows of G and (me + mi)/8
    rows of [A; C], t and x twice in their exchange form (two floats an
    element at "high"), its n/8 rows of g (and, below "highest", of the f32
    x) and three vectors of its stacked rows, four mbarriers
    (csrc/prox_chunk_cluster.cu: prox_cluster_floats)."""
    mt = me + mi
    nr, mr = n // CLUSTER, mt // CLUSTER
    width = 2 if dot_precision == "high" else 1
    own = 1 if dot_precision == "highest" else 2
    return 4 * (16 + nr * mt + mr * n + 2 * width * (mt + n) + own * nr
                + 3 * mr)


def chunk_kernel(n: int, me: int, mi: int, lanes: int, dot_precision: str,
                 smem_per_cta: int = SMEM_PER_CTA) -> str:
    """The kernel a sigma-free prox chunk launch runs: "cluster" (one lane
    per cluster of :data:`CLUSTER` CTAs, G, A and C held in registers, the
    next lane's rows loaded into shared memory meanwhile) at every
    ``dot_precision`` ("highest", "high", "default") and ``lanes``
    (ignored: one lane a cluster, and the outputs do not depend on it),
    when the lane fits the cluster (:func:`.cluster.fits` at (n, me + mi),
    with :func:`cluster_smem_bytes` at ``dot_precision`` within
    ``smem_per_cta``); else "stream" (prox_chunk.cu, the matrices read
    from device memory every iteration)."""
    if dot_precision in PRECISIONS and fits(
            n, me + mi, lambda: cluster_smem_bytes(n, me, mi, dot_precision),
            smem_per_cta):
        return "cluster"
    return "stream"


def chunk_variant(n: int, me: int, mi: int, lanes: int,
                  dot_precision: str) -> str:
    """The key a sigma-free launch counts under in
    ``fused_proxqp_chunk.variants``: "precision,lanesL", with ",cluster"
    when :func:`chunk_kernel` sends it to the cluster kernel."""
    key = f"{dot_precision},lanes{lanes}"
    if chunk_kernel(n, me, mi, lanes, dot_precision) == "cluster":
        key += ",cluster"
    return key


def _launch_sigma_free(wrapper, kernel, G, A, C, g, b, d, x, s, y, z, rho,
                       active, *, K, lanes, dot_precision, variant=None):
    """Check a sigma-free chunk's operands and launch ``kernel`` ("stream"
    or "cluster"), counted on ``wrapper``; returns (x, s, y, z)."""
    B, n = x.shape
    me, mi = b.shape[-1], d.shape[-1]
    if dot_precision not in PRECISIONS:
        raise ValueError(f"dot_precision must be one of {tuple(PRECISIONS)}; "
                         f"got {dot_precision!r}")
    _check_lanes(B, lanes)
    if K < 1:
        raise ValueError(f"{wrapper.__name__}: K must be >= 1; got {K}")
    if me % 4 or mi % 4 or not (me and mi):
        raise ValueError(f"{wrapper.__name__}: me and mi must be nonzero "
                         f"multiples of 4; got me={me}, mi={mi}")
    outs = [torch.empty_like(v) for v in (x, s, y, z)]
    act = _build.check_chunk(
        wrapper.__name__,
        {"G": (G, (B, n, me + mi)), "A": (A, (B, me, n)), "C": (C, (B, mi, n)),
         "g": (g, (B, n)), "b": (b, (B, me)), "d": (d, (B, mi)),
         "x": (x, (B, n)), "s": (s, (B, mi)), "y": (y, (B, me)),
         "z": (z, (B, mi)), "rho": (rho, (B,))},
        {"n": n, "me + mi": me + mi}, outs, active)
    ptrs = (G.data_ptr(), A.data_ptr(), C.data_ptr(), g.data_ptr(),
            b.data_ptr(), d.data_ptr(), rho.data_ptr(), x.data_ptr(),
            s.data_ptr(), y.data_ptr(), z.data_ptr(), act.data_ptr(),
            *(o.data_ptr() for o in outs))
    if kernel == "cluster":
        _build.launch(wrapper, "qps_prox_chunk_cluster", *ptrs, B, n, me, mi,
                      K, PRECISIONS[dot_precision], _build.stream_ptr(x),
                      variant=variant)
    else:
        _build.launch(wrapper, "qps_prox_chunk", *ptrs, B, n, me, mi, K, lanes,
                      PRECISIONS[dot_precision], _build.stream_ptr(x),
                      variant=variant)
    return tuple(outs)


def fused_proxqp_chunk(G, A, C, g, b, d, x, s, y, z, rho, active, *, K: int,
                       lanes: int = 1, dot_precision: str = "highest"):
    """Run K sigma-free prox-ALM iterations for every active lane.

    G (B, n, me + mi) = M^{-1}[A' C'], A (B, me, n), C (B, mi, n),
    g (B, n) = M^{-1}q, b/y (B, me), d/s/z (B, mi), x (B, n), rho (B,),
    active (B,) bool; ``lanes`` lanes per CTA (B must divide);
    ``dot_precision`` of G t, C x and A x: "highest", "high" (bf16x3) or
    "default" (one bf16 pass). Returns (x, s, y, z); a frozen lane passes
    its inputs through unchanged.

    On a CUDA tensor the launch runs the kernel :func:`chunk_kernel` names
    and counts under its :func:`chunk_variant` key, e.g.
    "high,lanes2,cluster" or "highest,lanes1" (a lane that does not fit a
    cluster).
    """
    if not _build.launches_kernel("fused_proxqp_chunk", x):
        return fused_proxqp_chunk_plain(G, A, C, g, b, d, x, s, y, z, rho,
                                        active, K=K, lanes=lanes,
                                        dot_precision=dot_precision)
    n, me, mi = x.shape[-1], b.shape[-1], d.shape[-1]
    return _launch_sigma_free(
        fused_proxqp_chunk, chunk_kernel(n, me, mi, lanes, dot_precision),
        G, A, C, g, b, d, x, s, y, z, rho, active, K=K, lanes=lanes,
        dot_precision=dot_precision,
        variant=chunk_variant(n, me, mi, lanes, dot_precision))


fused_proxqp_chunk.launches = 0
fused_proxqp_chunk.variants = collections.Counter()


def fused_proxqp_chunk_streaming(G, A, C, g, b, d, x, s, y, z, rho, active,
                                 *, K: int, lanes: int = 1,
                                 dot_precision: str = "highest"):
    """:func:`fused_proxqp_chunk` through the streaming kernel
    (prox_chunk.cu) in every variant, whatever :func:`chunk_kernel` says:
    the cluster kernel's bit-for-bit witness and timing baseline on the
    card (no solver calls it). Counts on its own ``launches``; on a CPU
    tensor the plain version."""
    if not _build.launches_kernel("fused_proxqp_chunk_streaming", x):
        return fused_proxqp_chunk_plain(G, A, C, g, b, d, x, s, y, z, rho,
                                        active, K=K, lanes=lanes,
                                        dot_precision=dot_precision)
    return _launch_sigma_free(
        fused_proxqp_chunk_streaming, "stream", G, A, C, g, b, d, x, s, y, z,
        rho, active, K=K, lanes=lanes, dot_precision=dot_precision)


fused_proxqp_chunk_streaming.launches = 0


def fused_proxqp_chunk_cluster(G, A, C, g, b, d, x, s, y, z, rho, active, *,
                               K: int, dot_precision: str = "highest"):
    """:func:`fused_proxqp_chunk` through the cluster kernel
    (csrc/prox_chunk_cluster.cu) at ``dot_precision``, whatever the
    solver's rule would pick (it takes no ``lanes``: one lane a cluster).
    Raises ValueError where :func:`chunk_kernel` refuses the shape. Counts
    on its own ``launches``; on a CPU tensor the plain version."""
    n, me, mi = x.shape[-1], b.shape[-1], d.shape[-1]
    if chunk_kernel(n, me, mi, 1, dot_precision) != "cluster":
        raise ValueError(f"fused_proxqp_chunk_cluster: n={n}, me={me}, "
                         f"mi={mi} do not fit a cluster of {CLUSTER} CTAs at "
                         f"{dot_precision!r}")
    if not _build.launches_kernel("fused_proxqp_chunk_cluster", x):
        return fused_proxqp_chunk_plain(G, A, C, g, b, d, x, s, y, z, rho,
                                        active, K=K,
                                        dot_precision=dot_precision)
    return _launch_sigma_free(
        fused_proxqp_chunk_cluster, "cluster", G, A, C, g, b, d, x, s, y, z,
        rho, active, K=K, lanes=1, dot_precision=dot_precision)


fused_proxqp_chunk_cluster.launches = 0


def cluster_occupancy(n: int, me: int, mi: int,
                      dot_precision: str = "highest") -> int:
    """How many clusters of the prox cluster chunk at (n, me + mi) and
    ``dot_precision`` the current card holds at once
    (cudaOccupancyMaxActiveClusters): the lanes in flight, and the clusters
    a launch starts."""
    import ctypes

    out = ctypes.c_int(0)
    _build.check(_build.load().lib.qps_prox_chunk_cluster_occupancy(
        n, me + mi, PRECISIONS[dot_precision], ctypes.byref(out)),
        "qps_prox_chunk_cluster_occupancy")
    return out.value


def fused_proxqp_chunk_minv_plain(Minv, A, C, P, q, b, d, x, s, y, z, rho,
                                  active, *, K: int, sigma: float, refine: int,
                                  lanes: int = 1):
    """Plain PyTorch M^{-1}-form chunk; same arguments and outputs as
    :func:`fused_proxqp_chunk_minv`. Any float dtype, device and batch shape
    (A, C, P, q, b and d may be shared across the batch)."""
    if x.dim() == 2:
        _check_lanes(x.shape[0], lanes)
    r = rho[..., None]
    At, Ct = A.transpose(-1, -2), C.transpose(-1, -2)

    def kkt_solve(x, s, y, z):
        rhs = (-q + sigma * x + matvec(At, r * b - y)
               + matvec(Ct, r * (d - s) - z))
        x = matvec(Minv, rhs)
        for _ in range(refine):
            Mx = (matvec(P, x) + sigma * x
                  + r * (matvec(At, matvec(A, x)) + matvec(Ct, matvec(C, x))))
            x = x + matvec(Minv, rhs - Mx)
        return x

    return _plain_chunk(kkt_solve, A, C, b, d, x, s, y, z, rho, active, K=K)


def minv_cluster_smem_bytes(n: int, me: int, mi: int, refine: int) -> int:
    """Shared memory one CTA of the M^{-1}-form prox cluster chunk needs at
    (n, me, mi): five mbarriers, the exchange buffers t, [A x; C x]
    (me + mi each), rhs, x and the residual (n each), its vector rows, the
    A' and C' products' partial sums, this lane's (me + mi) x n/8 columns of
    [A; C] and, when ``refine`` > 0, its n/8 x n rows of P
    (csrc/prox_chunk_minv_cluster.cu: prox_minv_cluster_floats)."""
    mt = me + mi
    nr, mr = n // CLUSTER, mt // CLUSTER
    groups = 256 // (n // 4)
    return 4 * (16 + 2 * mt + 3 * n + 4 * nr + 3 * mr + 2 * groups * nr
                + mt * nr + (nr * n if refine > 0 else 0))


def minv_chunk_kernel(n: int, me: int, mi: int, lanes: int, refine: int,
                      smem_per_cta: int = SMEM_PER_CTA) -> str:
    """The kernel an M^{-1}-form prox chunk launch runs: "cluster" (one
    lane per cluster of :data:`CLUSTER` CTAs, M^{-1} and [A; C] rows in
    registers, [A; C]'s columns and, with refinement, P's rows in shared
    memory, for all K iterations) at any ``lanes`` (ignored: one lane a
    cluster) when the lane fits the cluster (:func:`.cluster.fits` at
    (n, me + mi), and :func:`minv_cluster_smem_bytes` within
    ``smem_per_cta``); else "stream" (prox_chunk.cu: prox_chunk_minv_kernel,
    every matrix read from device memory each time it is used)."""
    if fits(n, me + mi, lambda: minv_cluster_smem_bytes(n, me, mi, refine),
            smem_per_cta):
        return "cluster"
    return "stream"


def minv_chunk_variant(n: int, me: int, mi: int, lanes: int,
                       refine: int) -> str:
    """The key an M^{-1}-form launch counts under in
    ``fused_proxqp_chunk_minv.variants``: "lanesL", with ",cluster" when
    :func:`minv_chunk_kernel` sends it to the cluster kernel."""
    key = f"lanes{lanes}"
    if minv_chunk_kernel(n, me, mi, lanes, refine) == "cluster":
        key += ",cluster"
    return key


def _launch_minv(wrapper, kernel, Minv, A, C, P, q, b, d, x, s, y, z, rho,
                 active, *, K, sigma, refine, lanes, variant=None):
    """Check an M^{-1}-form prox chunk's operands and launch ``kernel``
    ("stream" or "cluster"), counted on ``wrapper``; returns (x, s, y, z)."""
    B, n = x.shape
    me, mi = b.shape[-1], d.shape[-1]
    name = wrapper.__name__
    if K < 1 or refine < 0:
        raise ValueError(f"{name}: K must be >= 1 and refine >= 0; got K={K}, "
                         f"refine={refine}")
    _check_lanes(B, lanes)
    operands = {"Minv": (Minv, (B, n, n)), "A": (A, (B, me, n)),
                "C": (C, (B, mi, n)), "q": (q, (B, n)), "b": (b, (B, me)),
                "d": (d, (B, mi)), "x": (x, (B, n)), "s": (s, (B, mi)),
                "y": (y, (B, me)), "z": (z, (B, mi)), "rho": (rho, (B,))}
    if refine > 0:
        operands["P"] = (P, (B, n, n))
    outs = [torch.empty_like(v) for v in (x, s, y, z)]
    act = _build.check_chunk(name, operands, {"n": n, "me": me, "mi": mi},
                             outs, active)
    ptrs = (Minv.data_ptr(), A.data_ptr(), C.data_ptr(),
            P.data_ptr() if refine > 0 else None, q.data_ptr(), b.data_ptr(),
            d.data_ptr(), rho.data_ptr(), x.data_ptr(), s.data_ptr(),
            y.data_ptr(), z.data_ptr(), act.data_ptr(),
            *(o.data_ptr() for o in outs))
    if kernel == "cluster":
        _build.launch(wrapper, "qps_prox_chunk_minv_cluster", *ptrs, B, n, me,
                      mi, K, refine, float(sigma), _build.stream_ptr(x),
                      variant=variant)
    else:
        _build.launch(wrapper, "qps_prox_chunk_minv", *ptrs, B, n, me, mi, K,
                      refine, lanes, float(sigma), _build.stream_ptr(x),
                      variant=variant)
    return tuple(outs)


def fused_proxqp_chunk_minv(Minv, A, C, P, q, b, d, x, s, y, z, rho, active,
                            *, K: int, sigma: float, refine: int,
                            lanes: int = 1):
    """Run K M^{-1}-form prox-ALM iterations for every active lane.

    Minv (B, n, n) = (P + sigma*I + rho(A'A + C'C))^{-1} (contracted as
    Minv @ r), A (B, me, n), C (B, mi, n), P (B, n, n) (read only when
    refine > 0; may then be None), q/x (B, n), b/y (B, me), d/s/z (B, mi),
    rho (B,), active (B,) bool. Each KKT solve takes ``refine`` refinement
    passes against the true M; ``lanes`` lanes per CTA (B must divide).
    Returns (x, s, y, z); a frozen lane passes its inputs through unchanged.

    On a CUDA tensor the launch runs the kernel :func:`minv_chunk_kernel`
    names and counts under its :func:`minv_chunk_variant` key, e.g.
    "lanes2,cluster" or "lanes1" (a lane that does not fit a cluster).
    """
    if not _build.launches_kernel("fused_proxqp_chunk_minv", x):
        return fused_proxqp_chunk_minv_plain(Minv, A, C, P, q, b, d, x, s, y,
                                             z, rho, active, K=K, sigma=sigma,
                                             refine=refine, lanes=lanes)
    n, me, mi = x.shape[-1], b.shape[-1], d.shape[-1]
    return _launch_minv(
        fused_proxqp_chunk_minv, minv_chunk_kernel(n, me, mi, lanes, refine),
        Minv, A, C, P, q, b, d, x, s, y, z, rho, active, K=K, sigma=sigma,
        refine=refine, lanes=lanes,
        variant=minv_chunk_variant(n, me, mi, lanes, refine))


fused_proxqp_chunk_minv.launches = 0
fused_proxqp_chunk_minv.variants = collections.Counter()


def fused_proxqp_chunk_minv_streaming(Minv, A, C, P, q, b, d, x, s, y, z, rho,
                                      active, *, K: int, sigma: float,
                                      refine: int, lanes: int = 1):
    """:func:`fused_proxqp_chunk_minv` through the streaming kernel
    (prox_chunk.cu: prox_chunk_minv_kernel) whatever
    :func:`minv_chunk_kernel` says: the cluster kernel's bit-for-bit
    witness and timing baseline on the card (no solver calls it). Counts
    on its own ``launches``; on a CPU tensor the plain version."""
    if not _build.launches_kernel("fused_proxqp_chunk_minv_streaming", x):
        return fused_proxqp_chunk_minv_plain(Minv, A, C, P, q, b, d, x, s, y,
                                             z, rho, active, K=K, sigma=sigma,
                                             refine=refine, lanes=lanes)
    return _launch_minv(
        fused_proxqp_chunk_minv_streaming, "stream", Minv, A, C, P, q, b, d,
        x, s, y, z, rho, active, K=K, sigma=sigma, refine=refine, lanes=lanes)


fused_proxqp_chunk_minv_streaming.launches = 0


def fused_proxqp_chunk_minv_cluster(Minv, A, C, P, q, b, d, x, s, y, z, rho,
                                    active, *, K: int, sigma: float,
                                    refine: int):
    """:func:`fused_proxqp_chunk_minv` through the cluster kernel
    (csrc/prox_chunk_minv_cluster.cu, one lane a cluster), whatever the
    solver's rule would pick. Raises ValueError where
    :func:`minv_chunk_kernel` refuses the shape. Counts on its own
    ``launches``; on a CPU tensor the plain version."""
    n, me, mi = x.shape[-1], b.shape[-1], d.shape[-1]
    if minv_chunk_kernel(n, me, mi, 1, refine) != "cluster":
        raise ValueError(f"fused_proxqp_chunk_minv_cluster: n={n}, me={me}, "
                         f"mi={mi}, refine={refine} do not fit a cluster of "
                         f"{CLUSTER} CTAs")
    if not _build.launches_kernel("fused_proxqp_chunk_minv_cluster", x):
        return fused_proxqp_chunk_minv_plain(Minv, A, C, P, q, b, d, x, s, y,
                                             z, rho, active, K=K, sigma=sigma,
                                             refine=refine)
    return _launch_minv(
        fused_proxqp_chunk_minv_cluster, "cluster", Minv, A, C, P, q, b, d, x,
        s, y, z, rho, active, K=K, sigma=sigma, refine=refine, lanes=1)


fused_proxqp_chunk_minv_cluster.launches = 0


def minv_cluster_occupancy(n: int, me: int, mi: int, refine: int) -> int:
    """How many clusters of the M^{-1}-form prox cluster chunk at
    (n, me + mi, refine) the current card holds at once
    (cudaOccupancyMaxActiveClusters): the lanes in flight, and the clusters
    a launch starts."""
    import ctypes

    out = ctypes.c_int(0)
    _build.check(_build.load().lib.qps_prox_chunk_minv_cluster_occupancy(
        n, me + mi, refine, ctypes.byref(out)),
        "qps_prox_chunk_minv_cluster_occupancy")
    return out.value
