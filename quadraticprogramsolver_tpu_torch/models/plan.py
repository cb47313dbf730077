"""Static execution plan: which kernel path will a solve take?

Counterpart of the JAX package's models/plan.py (box-form family only).
Every gate is static (shapes, dtype, device, settings), so the path is known
before the solve starts, and ``Settings.require_fused`` turns any requested
kernel that would not run into an error instead of a silent slowdown.

Dropped from the JAX plan: the scoped-VMEM byte gates
(models/admm.py:_fused_chunk_shape_ok there). They encode the TPU's 16 MB
scoped VMEM; the Hopper chunk kernel streams G and A from device memory and
holds only vectors in shared memory, so no such gate applies.
"""

from __future__ import annotations

import dataclasses
import math

from ..core.settings import Settings
from . import kkt as kkt_mod


@dataclasses.dataclass(frozen=True)
class SolvePlan:
    """Static description of the kernel paths one solve will execute."""

    #: Resolved KKT backend ("cholesky").
    backend: str
    #: Chunk implementation: "fused_kernel" or "torch".
    chunk: str
    #: Factor implementation: "fused_slab", "torch_cholesky_solve" or
    #: "torch_inverse".
    factor: str
    #: KKT cache layout: "G_g" or "M_inv".
    cache: str
    #: (n_pad, m_pad) when the solve pads to 128-multiples; else None.
    padded: tuple | None
    #: Why requested kernels will NOT run (empty = all on).
    fallback_reasons: tuple = ()


def _dtype_reason(dtype, device):
    if kkt_mod.kernel_dtype_ok(dtype, device):
        return None
    return (f"the kernels take float32 (float64 only through their plain "
            f"versions on the CPU); got {dtype} on {device}")


def plan(qp, settings: Settings) -> SolvePlan:
    """Execution plan for :func:`models.admm.solve` on this (qp, settings)."""
    reasons = []
    n, m = qp.n, qp.m
    device = qp.device
    dtype_reason = _dtype_reason(qp.dtype, device)
    if device.type not in ("cpu", "cuda"):
        dtype_reason = f"no kernels for device {device}"

    # --- auto-pad decision (models/admm.solve preamble) ---
    padded = None
    if (settings.fused_chunk and dtype_reason is None
            and len(qp.batch_shape) == 1
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

    def shape_reasons(what):
        out = []
        if dtype_reason:
            out.append(f"{what}: {dtype_reason}")
        if len(qp.batch_shape) != 1:
            out.append(f"{what} requires exactly one batch axis "
                       f"(got {qp.batch_shape})")
        if n % 128 or n == 0 or m % 128 or m == 0:
            out.append(f"{what} requires n, m nonzero multiples of 128 "
                       f"(n={n}, m={m})")
        return out

    chunk = "torch"
    if settings.fused_chunk:
        why = shape_reasons("fused chunk")
        if why:
            reasons.extend(why)
        else:
            chunk = "fused_kernel"

    if settings.fused_factor:
        why = shape_reasons("fused_factor")
        if not settings.sigma_free_rhs:
            why.append("fused_factor requires sigma_free_rhs")
        if why:
            reasons.extend(why)
            factor_fused = False
        else:
            factor_fused = True
            B = math.prod(qp.batch_shape)
            if B < 4:
                reasons.append(
                    f"fused_factor at B={B} < 4 inverts the pivot blocks by "
                    "Cholesky (the JAX package's size rule): the pivot kernel "
                    "does not run")
    else:
        factor_fused = False
    if factor_fused:
        factor = "fused_slab"
    elif settings.sigma_free_rhs:
        factor = "torch_cholesky_solve"
    else:
        factor = "torch_inverse"
    cache = "G_g" if settings.sigma_free_rhs else "M_inv"
    return SolvePlan(backend=kind.value, chunk=chunk, factor=factor,
                     cache=cache, padded=padded,
                     fallback_reasons=tuple(reasons))


def check_require_fused(p: SolvePlan, family: str = "ADMM") -> None:
    """Raise when a require_fused solve would fall off a requested path."""
    if p.fallback_reasons:
        raise ValueError(
            f"require_fused: the {family} solve would silently fall back:\n- "
            + "\n- ".join(p.fallback_reasons)
            + f"\n(plan: chunk={p.chunk}, factor={p.factor}, cache={p.cache},"
            f" padded={p.padded})")
