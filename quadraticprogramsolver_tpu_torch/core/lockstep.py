"""Lockstep of the solvers' host loops across the ranks of a distributed
solve.

The JAX package's loops are ``lax.while_loop``s inside one SPMD program, so
every device takes the same branch. The port replaces each loop predicate by
one host read of a small flag tensor a pass: "any lane running" and "any
lane's rho tripped" in the ADMM and prox check loops (models/admm.py,
models/proxqp.py), "some lane not done" a Krylov step (models/kkt.py:
``_minres``, ``_pcg``). In a distributed solve (parallel/) each rank runs
that loop on its own shard; inside :func:`lockstep` the flags are cast to
int32 and all-reduced with MAX over the solve's process group before they
are read, so every rank takes the same branch and none can wait alone in a
collective. For a fleet this is JAX's global predicate: every rank runs as
many checks as its slowest shard, with the same refactor decisions. Outside
:func:`lockstep` the read is the plain ``tolist()``. Every read is a
``qps.sync`` span (utils/profiling.py) in a trace.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from ..utils.profiling import span

_GROUP = contextvars.ContextVar("quadraticprogramsolver_lockstep_group",
                                default=None)


@contextlib.contextmanager
def lockstep(group):
    """Every :func:`read_flags` inside agrees over ``group`` (a
    torch.distributed process group; None: no agreement)."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def read_flags(flags: torch.Tensor) -> list[bool]:
    """The loop's one host read of a 1-D bool tensor: each flag OR-ed over
    the ranks of the enclosing :func:`lockstep` group."""
    with span("qps.sync"):
        group = _GROUP.get()
        if group is None:
            return flags.tolist()
        import torch.distributed as dist

        agreed = flags.to(torch.int32)
        dist.all_reduce(agreed, op=dist.ReduceOp.MAX, group=group)
        return [bool(v) for v in agreed.tolist()]
