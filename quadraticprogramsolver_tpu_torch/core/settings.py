"""Solver settings for the PyTorch port.

Same field names, defaults and ``ValueError`` checks as
``quadraticprogramsolver_tpu.core.settings`` (that module cannot be imported
here: its package imports jax). One check is the port's own: an unknown
``matmul_precision`` or ``factor_precision`` raises ``ValueError`` here,
where the JAX package raises only when a solve opens its scope.
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


def chunk_precision(settings, iteration: int) -> str:
    """The sigma-free chunk's product precision for the chunk that starts at
    ``iteration``: first_chunk_dot_precision for the first one, when set,
    else chunk_dot_precision (both families; the kernels' plain versions
    run any non-float32 dtype in full). A chunk_dot_precision other than
    "high" and "default" runs as "highest", as the JAX package's chunk
    kernels run it."""
    if iteration == 0 and settings.first_chunk_dot_precision is not None:
        return settings.first_chunk_dot_precision
    return dot_precision(settings.chunk_dot_precision)


def dot_precision(name: str) -> str:
    """A chunk_dot_precision as the chunk kernels read it: "high" and
    "default" as they are, any other string "highest"."""
    return name if name in DOT_PRECISIONS else "highest"


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
    #: Run each check interval as one launch of a chunk kernel
    #: (csrc/admm_chunk.cu: the sigma-free or the M^{-1} form).
    fused_chunk: bool = False
    #: Lanes per CTA of the chunk kernel (bit-identical results at any
    #: value); falls back to 1 when it does not divide the batch.
    chunk_lanes: int = 1
    #: The sigma-free chunk's iterate products: "highest" (FP32), "high"
    #: (bf16x3) or "default" (one bf16 pass, check products included).
    chunk_dot_precision: str = "highest"
    #: The first chunk's precision (None: chunk_dot_precision throughout).
    first_chunk_dot_precision: str | None = None
    record_history: bool = False
    check_infeasibility: bool = True
    eps_prim_inf: float = 1e-4
    eps_dual_inf: float = 1e-4
    scaling_iters: int = 0
    #: The precision of the solve's torch products (ops/linalg.py:
    #: products): "highest" (FP32), "high" (bf16x3) or "default" (one bf16
    #: pass), or JAX's other names for them (PRECISION_NAMES). The chunk
    #: kernels, the pivot kernel and the sparse products stay FP32.
    matmul_precision: str = "highest"
    #: The factor's product precision (None: matmul_precision). Off the
    #: slab, the products of M's build and of the blocked sweep around the
    #: FP32 pivot kernel (M^{-1}, or G and g); on the fused slab factor
    #: "high" runs the bf16x3 slab-level dots (csrc/slab_level.cu) and
    #: "default" the FP32 level, as in the JAX package.
    factor_precision: str | None = None
    #: Sigma-free right-hand side: cache G = M^{-1}A' and g = M^{-1}q, and
    #: iterate xx = G(rho z - y) - g. No f32 sigma floor (sigma_for).
    sigma_free_rhs: bool = False
    #: Build the sigma-free factor with the slab kernels
    #: (csrc/slab_build.cu, csrc/pivot_sweep.cu, csrc/slab_level.cu).
    fused_factor: bool = False
    #: The fused slab factor's pivot sweep (csrc/pivot_sweep.cu): "v3"
    #: (Jacobi-scaled, the default), "ref" (unscaled), "value" (v3's
    #: arithmetic, so v3's kernel), "r<q>" for q dividing 128 (q steps a
    #: group, 128/q groups) or "panel" (rank-8 panels). The M^{-1} and
    #: unfused sigma-free routes always run v3, as in the JAX package.
    pivot_variant: str = "v3"
    #: Keep the factor's slab as the cache: the chunk reads G as a window
    #: of it (row pitch kp + n), so no (B, n, m) G copy is made.
    slab_cache: bool = False
    #: Cache G as two bf16 halves {Ghi, Glo} split from the slab once; the
    #: chunk reads them from memory at chunk_dot_precision="high".
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
            raise ValueError("chunk_lanes must be >= 1 (0 would divide by "
                             "zero in the lane fallback; negatives disable it)")
        if not (0.0 < self.alpha < 2.0):
            raise ValueError("alpha must be in (0, 2)")
        for name in ("eps_abs", "eps_rel", "rho", "sigma", "delta"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")
        if self.sigma_free_rhs and self.kkt_refinement_steps > 0:
            raise ValueError(
                "sigma_free_rhs caches only G = M^{-1}A' and g = M^{-1}q — "
                "iterative refinement needs M^{-1}; set kkt_refinement_steps=0")
        if self.slab_cache and not (
                self.fused_factor and self.sigma_free_rhs and self.fused_chunk
                and not self.adaptive_rho):
            raise ValueError(
                "slab_cache requires fused_factor + sigma_free_rhs + "
                "fused_chunk and adaptive_rho=False (a rho refactor would "
                "hold two live slabs — the OOM this flag exists to avoid)")
        if self.split_cache and (self.slab_cache or not (
                self.fused_factor and self.sigma_free_rhs and self.fused_chunk
                and self.chunk_dot_precision == "high"
                and not self.adaptive_rho)):
            raise ValueError(
                "split_cache requires fused_factor + sigma_free_rhs + "
                "fused_chunk + chunk_dot_precision='high' with "
                "adaptive_rho=False, and excludes slab_cache")
        if self.first_chunk_dot_precision is not None:
            if self.first_chunk_dot_precision not in ("default", "high",
                                                      "highest"):
                raise ValueError("first_chunk_dot_precision must be one of "
                                 "'default'/'high'/'highest'")
            if not (self.fused_chunk and self.sigma_free_rhs):
                raise ValueError("first_chunk_dot_precision needs the fused "
                                 "sigma-free chunk (fused_chunk + "
                                 "sigma_free_rhs)")
            if self.split_cache:
                raise ValueError("first_chunk_dot_precision excludes "
                                 "split_cache (its G halves force 'high')")
        product_precision(self.matmul_precision, "matmul_precision")
        if self.factor_precision is not None:
            product_precision(self.factor_precision, "factor_precision")
        pivot_rank(self.pivot_variant)

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


@dataclasses.dataclass(frozen=True)
class ProxQPSettings:
    """Prox-ALM (ProxQP-style) solver settings (frozen, hashable); the same
    fields, defaults and checks as the JAX package's ProxQPSettings."""

    max_iterations: int = 2000
    eps_abs: float = 1e-7
    eps_rel: float = 1e-6
    check_interval: int = 50
    rho: float = 1e2
    sigma: float = 1e-2
    adaptive_rho: bool = True
    #: Residual-ratio trigger of the double-square-root rho update.
    tau: float = 10.0
    rho_min: float = 1e-5
    rho_max: float = 1e5
    kkt_refinement_steps: int = 1
    #: Inner-CG controls of the matrix-free path (SparseProxQP).
    cg_eps: float = 1e-9
    cg_max_iterations: int = 200
    cg_rel_eps: float = 0.0
    #: Stop once every lane has finished; False runs the full budget like
    #: the reference, latching converged lanes and freezing infeasible ones.
    early_exit: bool = True
    #: Run each check interval as one launch of a prox chunk kernel
    #: (csrc/prox_chunk.cu: the sigma-free or the M^{-1} form).
    fused_chunk: bool = False
    #: Lanes, iterate-product precision and first-chunk schedule of the
    #: sigma-free prox chunk, as in Settings.
    chunk_lanes: int = 1
    chunk_dot_precision: str = "highest"
    first_chunk_dot_precision: str | None = None
    #: Start from the equality-KKT solve (False: from zeros).
    kkt_warm_start: bool = True
    anderson_memory: int = 0
    anderson_reg: float = 1e-8
    #: Exact ALM (sigma dropped) with the cached columns Ga = M^{-1}A',
    #: Gc = M^{-1}C', g = M^{-1}q, M = P + rho(A'A + C'C); built by the slab
    #: kernels with A and C as two row blocks. Excludes refinement.
    sigma_free_rhs: bool = False
    check_infeasibility: bool = True
    eps_prim_inf: float = 1e-4
    eps_dual_inf: float = 1e-4
    record_history: bool = False
    #: Raise at setup when a requested kernel will not run (models/plan.py).
    require_fused: bool = False

    def __post_init__(self):
        if self.max_iterations < 1:
            raise ValueError("max_iterations must be positive")
        if self.check_interval < 1:
            raise ValueError("check_interval must be positive")
        if self.chunk_lanes < 1:
            raise ValueError("chunk_lanes must be >= 1 (0 would divide by "
                             "zero in the lane fallback; negatives disable it)")
        if self.first_chunk_dot_precision is not None:
            if self.first_chunk_dot_precision not in ("default", "high",
                                                      "highest"):
                raise ValueError("first_chunk_dot_precision must be one of "
                                 "'default'/'high'/'highest'")
            if not (self.fused_chunk and self.sigma_free_rhs):
                raise ValueError("first_chunk_dot_precision needs the fused "
                                 "sigma-free prox chunk (fused_chunk + "
                                 "sigma_free_rhs)")

    @property
    def num_checks(self) -> int:
        return -(-self.max_iterations // self.check_interval)


#: The chunk kernels' product precisions, in the order of their codes
#: (csrc/common.cuh: Prec): full FP32, bf16x3, one bf16 pass.
DOT_PRECISIONS = ("highest", "high", "default")
#: Every name the JAX package's precision scope takes for the three levels
#: (``lax.Precision``'s strings), and the level it means.
PRECISION_NAMES = {
    "highest": "highest", "float32": "highest",
    "high": "high", "bfloat16_3x": "high", "tensorfloat32": "high",
    "default": "default", "bfloat16": "default", "fastest": "default",
}


def product_precision(name: str, field: str = "precision") -> str:
    """The level ("highest", "high" or "default") a precision name means;
    ValueError on any other name (``field`` names it in the message)."""
    try:
        return PRECISION_NAMES[name]
    except (KeyError, TypeError):
        raise ValueError(f"{field} must be one of {sorted(PRECISION_NAMES)}; "
                         f"got {name!r}") from None


#: The pivot sweep's named formulations; "r<q>" adds one per divisor q of 128.
PIVOT_VARIANTS = ("v3", "ref", "value", "panel")


def pivot_rank(variant: str, nb: int = 128):
    """q of a rank-q pivot variant "r<q>", None for a named one; raises
    ValueError on any other string, and on q not dividing nb with the JAX
    package's message (which runs other strings as "ref" instead)."""
    if variant in PIVOT_VARIANTS:
        return None
    if variant.startswith("r") and variant[1:].isdigit():
        q = int(variant[1:])
        if q == 0 or nb % q:
            raise ValueError(f"rank-q variant needs nb % q == 0; got {nb}, {q}")
        return q
    raise ValueError(f"pivot_variant must be one of {PIVOT_VARIANTS} or "
                     f"'r<q>' with q dividing {nb}; got {variant!r}")
