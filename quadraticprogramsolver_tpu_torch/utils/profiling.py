"""Tracing and timing helpers (counterpart of the JAX package's
utils/profiling.py, whose package imports jax).

:func:`trace` records a ``torch.profiler`` trace (host and, where a card is
present, device activity) and writes it as a Chrome trace, viewable in
Perfetto or chrome://tracing; :class:`Timer` accumulates wall-clock time
around blocks that end in :func:`hard_sync`, since the card runs a launch
after the host has moved on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch


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


class Timer:
    """Accumulating wall-clock timer.

    Call :func:`hard_sync` on the result *inside* the block, else the
    measurement ends before the (asynchronously launched) device work does:

    >>> t = Timer()
    >>> with t.measure():
    ...     sol = pt.solve(qp, settings)
    ...     hard_sync(sol)
    """

    def __init__(self):
        self.total = 0.0
        self.count = 0

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.total += time.perf_counter() - t0
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


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
