"""Tracing helpers (counterpart of the JAX package's utils/profiling.py,
whose package imports jax).

:func:`span` marks a layer of the solve loops (``qps.solve``, ``qps.pad``,
``qps.factor``, ``qps.chunk``, ``qps.check``, ``qps.sync``,
``qps.anderson``, ``qps.polish``) as a host event on the profiler's clock,
and costs one flag read when no profiler runs. :func:`trace` records a
``torch.profiler`` trace (host and, where a card is present, device
activity, the spans among them) and writes it as a Chrome trace, viewable
in Perfetto or chrome://tracing; :func:`hard_sync` waits for the device
work a result depends on, since the card runs a launch after the host has
moved on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

#: What :func:`span` returns while no profiler runs.
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a host event while a
    torch.profiler runs, and does nothing otherwise.

    The event is a plain host event (``_RecordFunctionFast``), on the clock
    of the trace's device events, so a device idle gap can be put down to
    the span the host was in. It is not a user annotation
    (``record_function``), which the profiler would also copy onto the
    device timeline. With no profiler running, the only work is one read of
    the profiler's flag.
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace of the block into ``log_dir`` as
    ``trace_<pid>_<ns>.json`` (Chrome trace format):

    >>> with trace("/tmp/qps-trace"):
    ...     sol = pt.solve(qp, settings)
    ...     hard_sync(sol)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _tensors(tree):
    """Every tensor in a tree of dataclasses, dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def hard_sync(tree) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree`` (a
    Solution, a dict or list of tensors, a tensor) to finish its work."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
