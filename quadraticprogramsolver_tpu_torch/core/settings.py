"""Solver settings for the PyTorch port.

Same field names and defaults as ``quadraticprogramsolver_tpu.core.settings``
(that module cannot be imported here: its package imports jax). The port
implements a slice of the knobs; the validator RAISES on every knob the slice
does not implement instead of ignoring it, so a configuration never runs a
path other than the one it names.
"""

from __future__ import annotations

import dataclasses
import enum


class KKTBackendKind(enum.Enum):
    """KKT linear-system strategy (names match the JAX package)."""

    AUTO = "auto"
    CHOLESKY = "cholesky"
    KKT_LDL = "kkt_ldl"
    CG = "cg"
    KKT_MINRES = "kkt_minres"


MAX_DIRECT_KKT_DIM = 5000
MAX_DIRECT_DENSITY = 0.4

# Adaptive-rho clipping.
RHO_MIN = 1e-3
RHO_MAX = 1e6

# ADMM fixed-point tolerance factor.
EPS_ADMM_FACTOR = 1e-2

#: f32 floor for the proximal regularization sigma (see the JAX package's
#: settings.py for the conditioning rationale).
SIGMA_F32_FLOOR = 1e-4


def sigma_for(sigma: float, dtype) -> float:
    """Dtype-aware effective sigma: the f64 value, floored in f32."""
    import torch

    if dtype == torch.float32:
        return max(sigma, SIGMA_F32_FLOOR)
    return sigma


@dataclasses.dataclass(frozen=True)
class Settings:
    """OSQP-ADMM solver settings (frozen, hashable)."""

    max_iterations: int = 5000
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    rho: float = 1.0
    sigma: float = 1e-6
    alpha: float = 1.6
    delta: float = 1e-6
    adaptive_rho: bool = True
    rho_factor: float = 5.0
    check_interval: int = 25
    polish_iterations: int = 0
    polish_eps: float = 1e-6
    polish_max_krylov: int = 500
    cg_eps: float = 1e-9
    cg_max_iterations: int = 200
    cg_rel_eps: float = 0.0
    kkt_backend: KKTBackendKind = KKTBackendKind.AUTO
    kkt_refinement_steps: int = 1
    #: Run each check interval as one launch of the chunk kernel
    #: (csrc/admm_chunk.cu). Requires sigma_free_rhs in this port.
    fused_chunk: bool = False
    chunk_lanes: int = 1
    chunk_dot_precision: str = "highest"
    first_chunk_dot_precision: str | None = None
    record_history: bool = False
    check_infeasibility: bool = True
    eps_prim_inf: float = 1e-4
    eps_dual_inf: float = 1e-4
    scaling_iters: int = 0
    matmul_precision: str = "highest"
    factor_precision: str | None = None
    #: Sigma-free right-hand side: cache G = M^{-1}A' and g = M^{-1}q, and
    #: iterate xx = G(rho z - y) - g. No f32 sigma floor (sigma_for).
    sigma_free_rhs: bool = False
    #: Build the sigma-free factor with the slab kernels
    #: (csrc/slab_build.cu, csrc/pivot_sweep.cu, csrc/slab_level.cu).
    fused_factor: bool = False
    pivot_variant: str = "v3"
    slab_cache: bool = False
    split_cache: bool = False
    #: Raise at setup when a requested kernel will not run (models/plan.py).
    require_fused: bool = False
    rho_eq_scale: float = 1.0
    anderson_memory: int = 0
    anderson_reg: float = 1e-8

    def __post_init__(self):
        if self.max_iterations < 1:
            raise ValueError("max_iterations must be positive")
        if self.check_interval < 1:
            raise ValueError("check_interval must be positive")
        if self.chunk_lanes < 1:
            raise ValueError("chunk_lanes must be >= 1")
        if not (0.0 < self.alpha < 2.0):
            raise ValueError("alpha must be in (0, 2)")
        for name in ("eps_abs", "eps_rel", "rho", "sigma", "delta"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")
        if self.sigma_free_rhs and self.kkt_refinement_steps > 0:
            raise ValueError(
                "sigma_free_rhs caches only G = M^{-1}A' and g = M^{-1}q — "
                "iterative refinement needs M^{-1}; set kkt_refinement_steps=0")
        for name, reason in _unimplemented(self):
            raise NotImplementedError(
                f"Settings.{name}: {reason} is not implemented by the "
                "PyTorch port yet (see ROADMAP.md)")

    @property
    def eps_admm(self) -> float:
        """Fixed-point termination tolerance."""
        return min(self.eps_abs, self.eps_rel) * EPS_ADMM_FACTOR

    @property
    def num_checks(self) -> int:
        """Number of convergence-check chunks covering max_iterations."""
        return -(-self.max_iterations // self.check_interval)

    def sigma_for(self, dtype) -> float:
        """Proximal sigma with the dtype-aware floor, except under
        ``sigma_free_rhs`` where sigma perturbs the solution and stays at the
        user's value."""
        if self.sigma_free_rhs:
            return self.sigma
        return sigma_for(self.sigma, dtype)


def _unimplemented(s: Settings):
    """(field, reason) for every knob this slice of the port rejects."""
    if s.slab_cache:
        yield "slab_cache", "the slab-window G cache (a TPU layout knob)"
    if s.split_cache:
        yield "split_cache", "the pre-split bf16 G cache (a TPU layout knob)"
    if s.chunk_lanes != 1:
        yield "chunk_lanes", "lane interleave (a TPU layout knob)"
    if s.chunk_dot_precision != "highest":
        yield "chunk_dot_precision", "a reduced-precision chunk"
    if s.first_chunk_dot_precision is not None:
        yield "first_chunk_dot_precision", "the first-chunk precision schedule"
    if s.factor_precision not in (None, "highest"):
        yield "factor_precision", f"a {s.factor_precision!r}-precision factor"
    if s.matmul_precision != "highest":
        yield "matmul_precision", "reduced matmul precision"
    if s.pivot_variant != "v3":
        yield "pivot_variant", f"pivot variant {s.pivot_variant!r}"
    if s.anderson_memory > 0:
        yield "anderson_memory", "Anderson acceleration"
    if s.polish_iterations > 0:
        yield "polish_iterations", "polish"
    if s.scaling_iters > 0:
        yield "scaling_iters", "Ruiz scaling"
    if s.record_history:
        yield "record_history", "residual history"
    if s.kkt_backend not in (KKTBackendKind.AUTO, KKTBackendKind.CHOLESKY):
        yield "kkt_backend", f"the {s.kkt_backend.value} backend"
    if s.fused_chunk and not s.sigma_free_rhs:
        yield "fused_chunk", "the M^{-1}-form fused chunk (needs sigma_free_rhs)"
