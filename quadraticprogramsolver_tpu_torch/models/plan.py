"""Static execution plan: which kernel path will a solve take?

Counterpart of the JAX package's models/plan.py: :func:`plan` for the
box-form ADMM family, :func:`plan_proxqp` for the prox-ALM family.
Every gate is static (shapes, dtype, device, settings), so the path is known
before the solve starts, and ``Settings.require_fused`` turns any requested
kernel that would not run into an error instead of a silent slowdown.

Dropped from the JAX plan: the scoped-VMEM byte gates
(models/admm.py:_fused_chunk_shape_ok there), which also send lanes 4 with
"high", or lanes 8, at 512/256 to the JAX package's XLA chunk. They encode
the TPU's 16 MB scoped VMEM; the Hopper chunk kernel streams G and A from
device memory and holds only vectors in shared memory, so no such gate
applies and those configurations run the kernel here.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.settings import KKTBackendKind, Settings, dot_precision
from ..ops.linalg import kernel_dtype_ok, resolve_precision, sweep_ok
from . import kkt as kkt_mod


@dataclasses.dataclass(frozen=True)
class SolvePlan:
    """Static description of the kernel paths one solve will execute."""

    #: Resolved KKT backend ("cholesky", "kkt_ldl", "cg" or "kkt_minres";
    #: "prox_alm" for the prox family).
    backend: str
    #: Chunk implementation: "fused_kernel" or "torch" (the JAX plan's
    #: "xla").
    chunk: str
    #: Factor implementation: "fused_slab" (the slab kernels); "gj_sweep" or
    #: "sweep_inverse" (ops/linalg.py's Gauss-Jordan sweep around the pivot
    #: kernel, sigma-free or M^{-1} form); "torch_cholesky_solve" or
    #: "torch_inverse" (Cholesky, off the sweep's shapes); "ldl_scan"
    #: (KKT_LDL's column loop); "minres_precond" (KKT_MINRES's
    #: preconditioner); "jacobi_diag" (CG, and the matrix-free prox path);
    #: or "prepared" (a solve given a prepared factor).
    factor: str
    #: KKT cache layout: "G_g", "slab" (Settings.slab_cache), "split_bf16"
    #: (Settings.split_cache), "M_inv", "L_d" (KKT_LDL), "P_inv" (dense
    #: KKT_MINRES) or "diag" (CG, sparse KKT_MINRES) (ADMM); "Ga_Gc_g",
    #: "M_inv" or "diag" (prox).
    cache: str
    #: (n_pad, m_pad) when the solve pads to 128-multiples ((n_pad, me_pad,
    #: mi_pad) for the prox family); else None.
    padded: tuple | None
    #: Why requested kernels will NOT run (empty = all on).
    fallback_reasons: tuple = ()
    #: Lanes per CTA of the chunk kernel (after the B % chunk_lanes
    #: fallback); 1 on the torch chunk.
    lanes: int = 1
    #: Precision of the chunk's iterate products (chunk_dot_precision on the
    #: sigma-free chunk kernel at float32, else "highest").
    dot_precision: str = "highest"


def _small_batch_reason(what: str, B: int) -> str:
    return (f"{what} at B={B} < 4 inverts the pivot blocks by Cholesky (the "
            "JAX package's size rule): the pivot kernel does not run")


def _unfused_factor(sigma_free: bool, n: int, B: int, dtype, device,
                    kernels_asked: bool, reasons: list) -> str:
    """The factor off the slab kernels (ops/linalg.py: spd_solve for the
    sigma-free cache, spd_inverse for M^{-1}): the sweep around the pivot
    kernel where ``sweep_ok`` holds, else Cholesky. When the solve asks for
    kernels, a fleet below 4 lanes says why the pivot kernel will not run."""
    if sweep_ok(n, B, dtype, device):
        return "gj_sweep" if sigma_free else "sweep_inverse"
    if kernels_asked and sweep_ok(n, 4, dtype, device):
        reasons.append(_small_batch_reason(
            "the sigma-free factor" if sigma_free else "the M^{-1} factor", B))
    return "torch_cholesky_solve" if sigma_free else "torch_inverse"


def _chunk_knobs(batch, sigma_free: bool, dtype, settings, reasons: list):
    """(lanes, dot_precision) of a chunk kernel, with the B % chunk_lanes
    fallback's reason. The bf16 precisions apply to float32 only (a float64
    solve runs its products in full, as the JAX package's does)."""
    B = batch[0] if batch else 1
    lanes = settings.chunk_lanes
    if lanes > 1 and B % lanes:
        reasons.append(f"chunk_lanes={lanes} does not divide the fleet size "
                       f"B={B}; the kernel falls back to 1 lane")
        lanes = 1
    prec = (resolve_precision(dot_precision(settings.chunk_dot_precision),
                              dtype) if sigma_free else "highest")
    return lanes, prec


def _dtype_reason(dtype, device):
    if kernel_dtype_ok(dtype, device):
        return None
    return (f"the kernels take float32 (float64 only through their plain "
            f"versions on the CPU); got {dtype} on {device}")


def plan(qp, settings: Settings, prepared: bool = False) -> SolvePlan:
    """Execution plan for :func:`models.admm.solve` on this (qp, settings).

    ``prepared``: the solve is given a prepared factor (models/admm.py:
    ``prepare``). It then runs at the problem's own shape (no auto-pad)
    from that factor: M^{-1}, or G = M^{-1}A' with g refreshed (the
    "G_g" cache), which this plan models (the JAX plan does not). A lane
    whose rho trips refactors as an unprepared solve would.
    """
    reasons = []
    n, m = qp.n, qp.m
    device = qp.device
    dtype_reason = _dtype_reason(qp.dtype, device)
    if device.type not in ("cpu", "cuda"):
        dtype_reason = f"no kernels for device {device}"

    # --- auto-pad decision (models/admm.solve preamble) ---
    padded = None
    if (settings.fused_chunk and qp.is_dense and dtype_reason is None
            and not prepared and len(qp.batch_shape) == 1
            and m > 0 and (n % 128 or m % 128)):
        n_pad = -(-n // 128) * 128
        m_pad = -(-m // 128) * 128
        inflate = (n_pad * m_pad) / (n * m)
        if inflate <= 4.0:
            padded = (n_pad, m_pad)
            n, m = n_pad, m_pad
        else:
            reasons.append(f"auto-pad to ({n_pad}, {m_pad}) rejected: work "
                           f"inflation {inflate:.1f}x > 4x — solve runs the "
                           "torch chunk at the original shape")

    kind = kkt_mod.resolve_backend(settings.kkt_backend, qp)
    B = math.prod(qp.batch_shape)

    def shape_reasons(what):
        out = []
        if dtype_reason:
            out.append(f"{what}: {dtype_reason}")
        if len(qp.batch_shape) != 1:
            out.append(f"{what} requires exactly one batch axis "
                       f"(got {qp.batch_shape})")
        if n % 128 or n == 0 or m % 128 or m == 0:
            out.append(f"{what} requires n, m nonzero multiples of 128 "
                       f"(n={n}, m={m})"
                       + (" — a prepared solve is not padded" if prepared
                          else ""))
        return out

    chunk, lanes, dot_precision = "torch", 1, "highest"
    if settings.fused_chunk:
        if not qp.is_dense:
            why = ["fused chunk requires a dense QP"]
        else:
            why = shape_reasons("fused chunk")
            if kind is not KKTBackendKind.CHOLESKY:
                why.append(f"fused chunk requires the CHOLESKY backend "
                           f"(resolved {kind.value})")
        if why:
            reasons.extend(why)
        else:
            chunk = "fused_kernel"
            lanes, dot_precision = _chunk_knobs(
                qp.batch_shape, settings.sigma_free_rhs, qp.dtype, settings,
                reasons)

    if kind is not KKTBackendKind.CHOLESKY:
        # The JAX plan's names, and no factor reasons off CHOLESKY.
        if kind is KKTBackendKind.KKT_LDL:
            factor, cache = "ldl_scan", "L_d"
        elif kind is KKTBackendKind.KKT_MINRES:
            factor, cache = "minres_precond", "P_inv" if qp.is_dense else "diag"
        else:
            factor, cache = "jacobi_diag", "diag"
        return SolvePlan(backend=kind.value, chunk=chunk,
                         factor="prepared" if prepared else factor,
                         cache=cache, padded=padded,
                         fallback_reasons=tuple(reasons), lanes=lanes,
                         dot_precision=dot_precision)
    if prepared:
        return SolvePlan(backend=kind.value, chunk=chunk, factor="prepared",
                         cache="G_g" if settings.sigma_free_rhs else "M_inv",
                         padded=None, fallback_reasons=tuple(reasons),
                         lanes=lanes, dot_precision=dot_precision)
    if settings.fused_factor:
        why = shape_reasons("fused_factor")
        if not settings.sigma_free_rhs:
            why.append("fused_factor requires sigma_free_rhs")
        if why:
            reasons.extend(why)
            factor_fused = False
        else:
            factor_fused = True
            if B < 4:
                reasons.append(_small_batch_reason("fused_factor", B))
    else:
        factor_fused = False
    if factor_fused:
        factor = "fused_slab"
    elif dtype_reason is None:
        factor = _unfused_factor(settings.sigma_free_rhs, n, B, qp.dtype,
                                 device, settings.fused_chunk, reasons)
    else:
        factor = ("torch_cholesky_solve" if settings.sigma_free_rhs
                  else "torch_inverse")
    if not settings.sigma_free_rhs:
        cache = "M_inv"
    elif factor_fused and settings.split_cache and qp.dtype == torch.float32:
        cache = "split_bf16"
    elif factor_fused and settings.slab_cache:
        cache = "slab"
    else:
        # A float64 split_cache keeps G (its halves would round the solve).
        cache = "G_g"
        if not factor_fused and (settings.split_cache or settings.slab_cache):
            reasons.append(
                ("split_cache" if settings.split_cache else "slab_cache")
                + " falls back to the plain {G, g} cache (fused factor "
                "gates failed — see above)")
    return SolvePlan(backend=kind.value, chunk=chunk, factor=factor,
                     cache=cache, padded=padded,
                     fallback_reasons=tuple(reasons), lanes=lanes,
                     dot_precision=dot_precision)


def plan_proxqp(prob, settings, prepared: bool = False) -> SolvePlan:
    """Execution plan for :func:`models.proxqp.solve` (prox-ALM family).

    ``prepared``: the solve is given a prepared factor. It then runs at the
    problem's own shape (no auto-pad) with that factor, which this plan
    models (the JAX plan does not).
    """
    reasons = []
    n, me, mi = prob.n, prob.n_eq, prob.n_ineq
    batch = prob.batch_shape
    device = prob.device
    dtype_reason = _dtype_reason(prob.dtype, device)
    if device.type not in ("cpu", "cuda"):
        dtype_reason = f"no kernels for device {device}"
    if not prob.is_dense:
        # The matrix-free path (a SparseProxQP): CG with M's Jacobi diagonal
        # as the factor; no chunk kernel, no pad. (sigma_free_rhs raises in
        # the solve; the JAX plan names its dense factor there.)
        if settings.fused_chunk:
            reasons.append("fused prox chunk requires a dense ProxQPProblem")
            if dtype_reason:
                reasons.append(f"fused prox chunk: {dtype_reason}")
            reasons.append("fused prox chunk requires exactly one batch axis "
                           f"(got {batch})")
        factor, cache = (("gj_sweep", "Ga_Gc_g") if settings.sigma_free_rhs
                         else ("jacobi_diag", "diag"))
        return SolvePlan(backend="prox_alm", chunk="torch",
                         factor="prepared" if prepared else factor,
                         cache=cache, padded=None,
                         fallback_reasons=tuple(reasons))

    padded = None
    if (settings.fused_chunk and not prepared and dtype_reason is None
            and len(batch) == 1):
        r128 = lambda v: max(-(-v // 128) * 128, 128)  # noqa: E731
        tgt = (r128(n), r128(me), r128(mi))
        if tgt != (n, me, mi):
            padded = tgt
            n, me, mi = tgt

    # Why the kernels (the slab factor and the prox chunk) cannot run on
    # this problem; empty when they can.
    why = [dtype_reason] if dtype_reason else []
    if len(batch) != 1:
        why.append(f"exactly one batch axis is required (got {batch})")
    if n % 128 or me % 128 or mi % 128 or not (n and me and mi):
        why.append(f"nonzero 128-multiple dims are required (n={n}, "
                   f"n_eq={me}, n_ineq={mi})"
                   + (" — a prepared solve is not padded" if prepared else ""))

    chunk, lanes, dot_precision = "torch", 1, "highest"
    if settings.fused_chunk:
        reasons.extend(f"fused prox chunk: {w}" for w in why)
        if not why:
            chunk = "fused_kernel"
            lanes, dot_precision = _chunk_knobs(
                batch, settings.sigma_free_rhs, prob.dtype, settings, reasons)

    B = math.prod(batch)
    if prepared:
        factor = "prepared"
    elif settings.sigma_free_rhs and not why:
        factor = "fused_slab"
        if settings.fused_chunk and B < 4:
            reasons.append(_small_batch_reason("fused slab factor", B))
    elif dtype_reason is None:
        factor = _unfused_factor(settings.sigma_free_rhs, n, B, prob.dtype,
                                 device, settings.fused_chunk, reasons)
    else:
        factor = ("torch_cholesky_solve" if settings.sigma_free_rhs
                  else "torch_inverse")
    cache = "Ga_Gc_g" if settings.sigma_free_rhs else "M_inv"
    return SolvePlan(backend="prox_alm", chunk=chunk, factor=factor,
                     cache=cache, padded=padded,
                     fallback_reasons=tuple(reasons), lanes=lanes,
                     dot_precision=dot_precision)


def check_require_fused(p: SolvePlan, family: str = "ADMM") -> None:
    """Raise when a require_fused solve would fall off a requested path."""
    if p.fallback_reasons:
        raise ValueError(
            f"require_fused: the {family} solve would silently fall back:\n- "
            + "\n- ".join(p.fallback_reasons)
            + f"\n(plan: chunk={p.chunk}, factor={p.factor}, cache={p.cache},"
            f" lanes={p.lanes}, padded={p.padded})")
