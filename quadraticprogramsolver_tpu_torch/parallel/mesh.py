"""Process groups, device meshes and fleet-sharded solving (counterpart of
the JAX package's parallel/mesh.py).

The JAX package runs one SPMD program over a ``Mesh``; here every rank is a
process (``torch.distributed``) and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks, with the
JAX package's axis names: "qp" for a fleet (:data:`BATCH_AXIS`), "blocks"
for one QP's constraint rows (parallel/consensus.py) and both for the 2-D
case.

Global in, global out, as a JAX caller passes and gets global arrays: every
rank passes the whole fleet, solves its contiguous slice of the lanes (lanes
``r B/D : (r+1) B/D`` on the axis's rank r of D) on its own device with the
single-card solver, and gets the whole Solution back through ``all_gather``.
The loops agree through core/lockstep.py (one MAX all-reduce a check), which
is JAX's global predicate: every rank runs as many checks as its slowest
shard, so iterations, history rows and refactor decisions are the JAX mesh
solve's. On a card the shard's solve runs the single-card kernels: rows 1-3
and 4a (ADMM) or 5a (prox) on the sigma-free fused path.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

from ..core.lockstep import lockstep
from ..core.settings import ProxQPSettings, Settings
from ..core.state import Solution, Status
from ..models import admm, proxqp

BATCH_AXIS = "qp"

#: Seconds a collective may wait before its process group raises, unless the
#: caller of :func:`init_distributed` or :func:`make_mesh` says otherwise.
DEFAULT_TIMEOUT = 300.0


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def init_distributed(init_method: str = "env://", world_size: int = -1,
                     rank: int = -1, *, backend: str | None = None,
                     device: str = "cuda",
                     timeout: float = DEFAULT_TIMEOUT) -> None:
    """Join this process to the world (``init_process_group``); does nothing
    when the world exists already, so every entry point may call it.

    ``backend`` is given, never guessed after a failure: by default "nccl"
    for ranks on cards (``device="cuda"``, one rank a card) and "gloo" on
    the CPU; ranks that share one card pass ``backend="gloo"``. ``env://``
    reads MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK; any other
    ``init_method`` (``tcp://host:port``) takes ``world_size`` and ``rank``.
    ``timeout`` (seconds) bounds every collective of the group.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=_timeout(timeout))


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device: str = "cuda", timeout: float = DEFAULT_TIMEOUT):
    """A DeviceMesh of the world's ranks in row-major order over ``shape``
    with axes ``names``. A 1-D mesh over the whole world is its default
    group (``init_device_mesh``); otherwise every axis line is a group made
    with ``timeout`` (every rank makes every group, in one order)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    shape, names = tuple(shape), tuple(names)
    if len(shape) == 1 and shape[0] == dist.get_world_size():
        return init_device_mesh(device, shape, mesh_dim_names=names)
    grid = torch.arange(dist.get_world_size()).view(shape)
    rank = dist.get_rank()
    mine = []
    for dim in range(len(shape)):
        lines = grid.movedim(dim, -1).reshape(-1, shape[dim]).tolist()
        for line in lines:
            group = dist.new_group(line, timeout=_timeout(timeout))
            if rank in line:
                mine.append(group)
    return DeviceMesh.from_group(mine, device, mesh=grid,
                                 mesh_dim_names=names)


def make_fleet_mesh(device: str = "cuda", axis_name: str = BATCH_AXIS):
    """1-D mesh over the whole world for fleet data-parallelism."""
    return make_mesh((dist.get_world_size(),), (axis_name,), device)


def axis(mesh, name: str) -> tuple[int, int, object]:
    """(this rank's index on the axis, the axis's size, its group)."""
    size = mesh.shape[mesh.mesh_dim_names.index(name)]
    return mesh.get_local_rank(name), size, mesh.get_group(name)


def rank_device(mesh) -> torch.device:
    """This rank's device: its current card on a "cuda" mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


#: The dimensions of a problem's tensors without batch axes, by field.
_BASE_DIMS = {"P": 2, "q": 1, "A": 2, "l": 1, "u": 1, "b": 1, "C": 2, "d": 1}


def shard_fleet(problem, mesh, axis_name: str = BATCH_AXIS):
    """This rank's shard of a batched problem: its contiguous slice of the
    leading (fleet) axis over the mesh axis, on this rank's device. Works
    for any fleet problem whose per-lane tensors lead with the fleet axis
    (:class:`QP` and :class:`ProxQPProblem` both do)."""
    if not problem.batch_shape:
        raise ValueError("shard_fleet requires a batched problem "
                         "(leading fleet axis)")
    r, n_dev, _ = axis(mesh, axis_name)
    B = problem.batch_shape[0]
    if B % n_dev != 0:
        raise ValueError(
            f"fleet size {B} not divisible by mesh axis {n_dev}")
    lanes = slice(r * B // n_dev, (r + 1) * B // n_dev)
    dev = rank_device(mesh)
    # A matrix shared by the fleet (stored without the batch axis) stays so.
    return dataclasses.replace(problem, **{
        f.name: (t[lanes] if t.dim() > _BASE_DIMS[f.name] else t)
        .to(dev).contiguous()
        for f in dataclasses.fields(problem)
        for t in (getattr(problem, f.name),)})


def reducer(group, op):
    """``all_reduce`` with ``op`` over ``group`` as a function of one or
    more tensors of one dtype: ``reduce(t)`` returns the reduced copy of t,
    ``reduce(a, b, ...)`` reduces them all in one collective (concatenated)
    and returns them as a tuple. The block splits' psum and pmax."""
    def reduce(*ts):
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=op, group=group)
        if len(ts) == 1:
            return flat.view_as(ts[0])
        parts = flat.split([t.numel() for t in ts])
        return tuple(p.view_as(t) for p, t in zip(parts, ts))

    return reduce


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors ``t`` concatenated along ``dim`` in rank order
    (``all_gather`` in its list form)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def gather_lanes(obj, group):
    """A solution dataclass (Solution, SolveInfo, ProxQPSolution,
    ProxQPInfo) with every per-lane tensor gathered over ``group``: the
    lane axis leads, except in a history trace (num_checks, *B), where it
    is axis 1. ``ProxQPInfo.converged`` is recomputed from the status."""
    def walk(v, dim):
        if v is None:
            return None
        if isinstance(v, torch.Tensor):
            return all_gather_cat(v, group, dim)
        if isinstance(v, dict):
            return {k: walk(w, 1) for k, w in v.items()}
        return gather_lanes(v, group)

    fields = {f.name: walk(getattr(obj, f.name), 0)
              for f in dataclasses.fields(obj) if f.name != "converged"}
    if isinstance(obj, proxqp.ProxQPInfo):
        fields["converged"] = fields["status"] == Status.SOLVED
    return type(obj)(**fields)


def solve_fleet(qp, settings: Settings = Settings(), mesh=None,
                axis_name: str = BATCH_AXIS, prepared=None) -> Solution:
    """Solve a fleet of box-form QPs, its lanes split over the mesh axis.

    Every rank passes the whole fleet (on any device) and gets the whole
    Solution back on its own device. ``prepared``: this rank's
    :class:`~..models.admm.PreparedFactor`, built by ``prepare`` on
    ``shard_fleet(qp, mesh)``. ``mesh`` defaults to
    :func:`make_fleet_mesh` on the cards.
    """
    mesh = make_fleet_mesh() if mesh is None else mesh
    local = shard_fleet(qp, mesh, axis_name)
    group = mesh.get_group(axis_name)
    with lockstep(group):
        sol = admm.solve(local, settings, prepared=prepared)
    return gather_lanes(sol, group)


def solve_prox_fleet(prob, settings: ProxQPSettings = ProxQPSettings(),
                     mesh=None, axis_name: str = BATCH_AXIS,
                     prepared=None) -> proxqp.ProxQPSolution:
    """Fleet data-parallelism for the prox-ALM family: each rank solves its
    slice of a fleet of split-form QPs with the whole single-card solver
    (the equality-KKT warm start, the sigma-free cache, Anderson and the
    certificates run on the shard), and every rank gets the whole solution.
    ``prepared`` as for :func:`solve_fleet` (``prepare_proxqp`` on the
    shard)."""
    mesh = make_fleet_mesh() if mesh is None else mesh
    local = shard_fleet(prob, mesh, axis_name)
    group = mesh.get_group(axis_name)
    with lockstep(group):
        sol = proxqp.solve(local, settings, prepared=prepared)
    return gather_lanes(sol, group)
