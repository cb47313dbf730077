"""quadraticprogramsolver_tpu_torch — the PyTorch + CUDA port of
quadraticprogramsolver_tpu (batched OSQP-ADMM for fleets of dense QPs).

The main path runs on an NVIDIA H100 through hand-written kernels in
``csrc/`` (built with nvcc for sm_90a at first use, loaded through ctypes);
on CPU tensors every kernel wrapper runs its plain PyTorch version. This
package imports torch, numpy and ctypes, never jax.
"""

from .core.problem import QP, make_qp, pad_qp, validate_qp
from .core.settings import KKTBackendKind, Settings
from .core.state import SolveInfo, Solution, Status
from .models.admm import solve, solve_jit
from .models.plan import SolvePlan, plan

__all__ = [
    "QP",
    "make_qp",
    "pad_qp",
    "validate_qp",
    "Settings",
    "KKTBackendKind",
    "Status",
    "SolveInfo",
    "Solution",
    "solve",
    "solve_jit",
    "plan",
    "SolvePlan",
]
