"""Device ms per solve of the factor layer (models/kkt.py: cholesky_init and
models/proxqp.py's sigma-free cache -> ops/fused_factor.py,
ops/spd_kernels.py): the kernels below, by name in the trace."""

#: csrc/slab_build.cu, csrc/pivot_sweep.cu, csrc/slab_level.cu (FP32 and
#: bf16x3 strip levels).
KERNELS = ("slab_build_kernel", "pivot_sweep_v3_kernel", "level_strip_kernel")


def read(run):
    t = run.trace
    ms = t.ms_matching(KERNELS) if t is not None else 0.0
    return ms / t.solves if ms > 0 else None
