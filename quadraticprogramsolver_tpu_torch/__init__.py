"""quadraticprogramsolver_tpu_torch — the PyTorch + CUDA port of
quadraticprogramsolver_tpu (batched OSQP-ADMM and prox-ALM for fleets of
dense QPs, and both with matrix-free Krylov solves for one large sparse
QP).

Both families and the sparse path run on an NVIDIA H100 through
hand-written kernels in ``csrc/`` (built with nvcc for sm_90a at first use,
loaded through ctypes); on CPU tensors every kernel wrapper runs its plain
PyTorch version. This package imports torch, numpy, scipy and ctypes, never
jax.
"""

from .core.problem import (QP, ProxQPProblem, make_proxqp, make_qp,
                           pad_proxqp, pad_qp, stack_qps, validate_qp)
from .core.settings import KKTBackendKind, ProxQPSettings, Settings
from .core.sparse_problem import (SparseProxQP, SparseQP, make_sparse_proxqp,
                                  make_sparse_qp)
from .core.state import SolveInfo, Solution, Status
from .frontends.reuse import CachedQPSolver
from .models.admm import PreparedFactor, prepare, prepare_jit, solve, solve_jit
from .models.plan import SolvePlan, plan, plan_proxqp
from .models.proxqp import PreparedProxFactor, ProxQPSolution
from .models.proxqp import prepare as prepare_proxqp
from .models.proxqp import solve as solve_proxqp
from .models.proxqp import solve_jit as solve_proxqp_jit
from .problems.generator import (ALL_CLASSES, ProblemClass, generate_batch,
                                 generate_large_sparse_qp, generate_random_qp)

__version__ = "0.1.0"

__all__ = [
    "QP",
    "ProxQPProblem",
    "SparseQP",
    "SparseProxQP",
    "make_qp",
    "make_proxqp",
    "make_sparse_qp",
    "make_sparse_proxqp",
    "pad_qp",
    "pad_proxqp",
    "stack_qps",
    "validate_qp",
    "Settings",
    "ProxQPSettings",
    "KKTBackendKind",
    "SolveInfo",
    "Solution",
    "Status",
    "solve",
    "solve_jit",
    "SolvePlan",
    "plan",
    "plan_proxqp",
    "PreparedFactor",
    "prepare",
    "prepare_jit",
    "PreparedProxFactor",
    "prepare_proxqp",
    "CachedQPSolver",
    "solve_proxqp",
    "solve_proxqp_jit",
    "ProxQPSolution",
    "ProblemClass",
    "ALL_CLASSES",
    "generate_random_qp",
    "generate_batch",
    "generate_large_sparse_qp",
    "__version__",
]
