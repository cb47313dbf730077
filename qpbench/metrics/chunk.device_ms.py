"""Device ms per solve of the iterate chunks (ops/fused_admm.py,
ops/fused_proxqp.py): every chunk kernel of both families, cluster,
streaming and M^-1 forms alike, by name in the trace."""

#: csrc/admm_chunk*.cu, csrc/prox_chunk*.cu.
KERNELS = ("admm_chunk", "prox_chunk")


def read(run):
    t = run.trace
    ms = t.ms_matching(KERNELS) if t is not None else 0.0
    return ms / t.solves if ms > 0 else None
