"""quadraticprogramsolver_tpu_torch — the PyTorch + CUDA port of
quadraticprogramsolver_tpu (batched OSQP-ADMM and prox-ALM for fleets of
dense QPs, and OSQP-ADMM with matrix-free CG for one large sparse QP).

Both families and the sparse path run on an NVIDIA H100 through
hand-written kernels in ``csrc/`` (built with nvcc for sm_90a at first use,
loaded through ctypes); on CPU tensors every kernel wrapper runs its plain
PyTorch version. This package imports torch, numpy, scipy and ctypes, never
jax.
"""

from .core.problem import (QP, ProxQPProblem, make_proxqp, make_qp,
                           pad_proxqp, pad_qp, validate_qp)
from .core.settings import KKTBackendKind, ProxQPSettings, Settings
from .core.sparse_problem import SparseQP, make_sparse_qp
from .core.state import SolveInfo, Solution, Status
from .models.admm import solve, solve_jit
from .models.plan import SolvePlan, plan, plan_proxqp
from .models.proxqp import PreparedProxFactor, ProxQPSolution
from .models.proxqp import prepare as prepare_proxqp
from .models.proxqp import solve as solve_proxqp
from .models.proxqp import solve_jit as solve_proxqp_jit
from .problems.generator import generate_large_sparse_qp

__all__ = [
    "QP",
    "make_qp",
    "pad_qp",
    "validate_qp",
    "SparseQP",
    "make_sparse_qp",
    "generate_large_sparse_qp",
    "Settings",
    "KKTBackendKind",
    "Status",
    "SolveInfo",
    "Solution",
    "solve",
    "solve_jit",
    "plan",
    "SolvePlan",
    "ProxQPProblem",
    "make_proxqp",
    "pad_proxqp",
    "ProxQPSettings",
    "solve_proxqp",
    "solve_proxqp_jit",
    "prepare_proxqp",
    "PreparedProxFactor",
    "ProxQPSolution",
    "plan_proxqp",
]
