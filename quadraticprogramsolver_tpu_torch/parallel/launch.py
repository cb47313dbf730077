"""Spawn a world of ranks on one host, run a function on each, and bring its
results back.

``spawn(fn, world_size)`` starts ``world_size`` processes with
``torch.multiprocessing``'s "spawn" method, joins them into one
torch.distributed world on a free local port (:func:`~.mesh.init_distributed`,
with a timeout on every collective), pins one torch thread in each, and
returns ``fn(*args)`` of every rank in rank order, with every tensor in it
copied to a numpy array (a result crosses the process boundary by value).
``fn`` must be importable in a fresh interpreter (a module-level function).

:func:`run_calls` is a ``fn`` for ``spawn``: it runs a list of calls
(:class:`Call`: an entry point with its mesh, or a method of an earlier
call's result) on every rank and returns each call's result or its error,
so one world serves many cases.

A rank that raises fails the whole call with its traceback. The parent waits
for the results until a deadline and then kills what is left, so a rank
stuck in a collective fails one call instead of hanging its caller.

The ranks run on the cards unless the caller asks for the CPU
(``device="cpu"``, as the tests do): rank r uses card r mod the card count
(several ranks on one card share it; NCCL refuses that, so they pass
``backend="gloo"``).
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import socket
import time
import traceback

from ..utils.interop import to_host
from .mesh import DEFAULT_TIMEOUT


def free_port() -> int:
    """A TCP port on the loopback interface that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def host_tree(obj):
    """``obj`` with every torch tensor replaced by a numpy copy
    (``utils/interop.py: to_host``), through dicts, lists, tuples and
    dataclasses."""
    import torch

    if isinstance(obj, torch.Tensor):
        return to_host(obj)
    if isinstance(obj, dict):
        return {k: host_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_tree(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: host_tree(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


@dataclasses.dataclass(frozen=True)
class Ref:
    """An argument of a :class:`Call`: the result of call ``index`` of the
    same :func:`run_calls` list, as the rank holds it (not a host copy)."""

    index: int


@dataclasses.dataclass(frozen=True)
class Call:
    """One step of :func:`run_calls`: ``fn(*args, **kwargs)`` on every rank,
    with :class:`Ref` arguments resolved and, when ``mesh`` is a
    ``(shape, names)`` pair, ``mesh=`` the DeviceMesh of that layout on the
    ranks' device. ``out=False`` returns None for it (a result that stays on
    the ranks, such as a solver object). ``rank``: run it on that rank only
    (a call without collectives); the others hold None for it."""

    fn: object
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    mesh: tuple | None = None
    out: bool = True
    rank: int | None = None


def run_calls(calls, device: str = "cuda",
              timeout: float = DEFAULT_TIMEOUT) -> list:
    """Run ``calls`` in order on this rank: a list with, for each call,
    ``(True, result)`` (through :func:`host_tree`) or ``(False,
    traceback)``. A mesh layout is made once
    (its groups with ``timeout``) and reused by every call that names it."""
    import torch.distributed as dist

    from .mesh import make_mesh

    meshes = {}
    held = []
    out = []

    def resolve(v):
        return held[v.index] if isinstance(v, Ref) else v

    for call in calls:
        if call.rank is not None and call.rank != dist.get_rank():
            held.append(None)
            out.append((True, None))
            continue
        try:
            kwargs = {k: resolve(v) for k, v in call.kwargs.items()}
            if call.mesh is not None:
                key = (tuple(call.mesh[0]), tuple(call.mesh[1]))
                if key not in meshes:
                    meshes[key] = make_mesh(*key, device=device,
                                            timeout=timeout)
                kwargs["mesh"] = meshes[key]
            value = call.fn(*(resolve(a) for a in call.args), **kwargs)
            held.append(value)
            out.append((True, host_tree(value) if call.out else None))
        except Exception:  # noqa: BLE001 - the case fails, the world goes on
            held.append(None)
            out.append((False, traceback.format_exc()))
    return out


def _rank_main(rank, world_size, port, backend, device, timeout, fn, args,
               kwargs, results):
    import torch
    import torch.distributed as dist

    from .mesh import init_distributed

    torch.set_num_threads(1)
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        init_distributed(f"tcp://127.0.0.1:{port}", world_size, rank,
                         backend=backend, device=device, timeout=timeout)
        out = host_tree(fn(*args, **kwargs))
        if device == "cuda":
            torch.cuda.synchronize()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, args=(), kwargs=None, *, device: str = "cuda",
          backend: str | None = None, timeout: float = DEFAULT_TIMEOUT,
          deadline: float | None = None) -> list:
    """``[fn(*args, **kwargs) on rank r for r in range(world_size)]``, each
    through :func:`host_tree`.

    ``backend`` defaults to "nccl" on cards and "gloo" on the CPU
    (:func:`~.mesh.init_distributed`). ``timeout`` bounds each collective;
    ``deadline`` (seconds, default 10 timeouts) bounds the whole call, after
    which every rank still running is killed and TimeoutError raised.
    """
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, port, backend, device, timeout,
                               fn, tuple(args), dict(kwargs or {}), results))
             for r in range(world_size)]
    end = time.monotonic() + (10 * timeout if deadline is None else deadline)
    for p in procs:
        p.start()
    out = [None] * world_size
    try:
        # Drain the queue before joining: a rank blocks on exit until the
        # parent has read what it put.
        pending = set(range(world_size))
        while pending:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r in pending if procs[r].exitcode is not None]
                if dead:
                    raise RuntimeError(
                        f"spawn: rank {dead[0]} of {fn.__qualname__} exited "
                        f"with code {procs[dead[0]].exitcode} before its "
                        "result") from None
                if time.monotonic() > end:
                    raise TimeoutError(
                        f"spawn: {len(pending)} of {world_size} ranks of "
                        f"{fn.__qualname__} gave no result before the "
                        "deadline") from None
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} of "
                                   f"{fn.__qualname__} failed:\n{value}")
            out[rank] = value
            pending.discard(rank)
        for p in procs:
            p.join(max(end - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
    return out

