"""The traced part of a ``--trace 1`` run: a few solves under
torch.profiler (CUPTI), reduced to device time by kernel name, the device's
busy time and its idle gaps.

``traced``, ``on_device`` and ``event_ms`` are copies of chip_smoke.py's:
a warm-up step inside the same profiling run takes the loss of the first
device events, and the traced call keeps TRACE_MARGIN_S from each edge of
the active step, since a kernel launched right at an edge can lose its
event.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time

#: Host time kept idle at each edge of a trace's active step.
TRACE_MARGIN_S = 0.05
#: Host events looked at, back from a gap's middle, to name the gap.
SCAN = 256


def traced(torch, fn):
    """(profiler, wall s) of one call of fn() traced by torch.profiler after
    a warm-up call in the same profiling run."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        sync()
        prof.step()  # warm-up -> active; leaving the block ends the trace
        time.sleep(TRACE_MARGIN_S)
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
        time.sleep(TRACE_MARGIN_S)
    return prof, wall


def on_device(e):
    """A device event of a trace: a kernel or a copy, not the schedule's
    ProfilerStep annotation (which the trace files under the device)."""
    from torch.autograd import DeviceType

    return (e.device_type == DeviceType.CUDA
            and not e.key.startswith("ProfilerStep"))


def event_ms(e):
    """An averaged trace event's device time in ms."""
    v = getattr(e, "self_device_time_total", None)
    return (v if v is not None else e.self_cuda_time_total) / 1e3


@dataclasses.dataclass
class Trace:
    """What the readers take from the traced solves."""

    solves: int                 # solves in the traced window
    window_s: float             # its wall time
    busy_s: float               # union of the device events' intervals
    device_ms: dict             # kernel name -> device ms over the window
    idle_gaps: list             # [(what the host was doing, seconds)]

    def ms_matching(self, names) -> float:
        """Device ms of the kernels whose name holds one of ``names`` (a
        template kernel's name reads "void name<...>(...)")."""
        return sum(v for k, v in self.device_ms.items()
                   if any(n in k for n in names))


def _intervals(events):
    out = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.time_range.end > e.time_range.start)
    merged = []
    for s, t in out:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def reduce(prof, wall_s: float, solves: int) -> Trace:
    """Device ms by name, busy seconds and the idle gaps, each gap named
    by the innermost host event that spans its middle."""
    device_ms = collections.Counter()
    for e in prof.key_averages():
        if on_device(e) and event_ms(e) > 0:
            device_ms[e.key] += event_ms(e)
    events = prof.events()
    dev = [e for e in events if on_device(e)]
    host = [e for e in events if not on_device(e)
            and not e.key.startswith("ProfilerStep")]
    busy = _intervals(dev)
    busy_s = sum(t - s for s, t in busy) / 1e6
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    gaps = collections.Counter()
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        name = "(no host event)"
        # The innermost host event spanning the middle is the one that
        # started last among those that still run there.
        i = bisect.bisect_right(starts, mid)
        for e in reversed(host[max(0, i - SCAN):i]):
            if e.time_range.end >= mid:
                name = e.key
                break
        gaps[name] += (b - a) / 1e6
    return Trace(solves=solves, window_s=wall_s, busy_s=busy_s,
                 device_ms=dict(device_ms),
                 idle_gaps=gaps.most_common(10))
