"""The port's spans and loop counters on the CPU: ``utils/profiling.py:
span`` around the layers of both solve loops, the ``qps.*`` host events
they leave in a torch.profiler trace, their cost with no profiler running,
and the loop counters ``models/admm.py: _solve_core.syncs`` and
``models/proxqp.py: _solve_impl.syncs`` / ``.solves``."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.models import admm, proxqp
from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
    device_random_qp_fleet)
from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
    device_prox_fleet)
from quadraticprogramsolver_tpu_torch.utils import profiling

#: The fused stacks of the benchmark's cells (the kernels' plain versions
#: run here).
FUSED = dict(rho=0.4, adaptive_rho=False, check_interval=11,
             kkt_refinement_steps=0, sigma_free_rhs=True, fused_factor=True,
             fused_chunk=True, require_fused=True)
PROX = dict(rho=0.0125, adaptive_rho=False, check_interval=25,
            kkt_warm_start=False, kkt_refinement_steps=0, sigma_free_rhs=True,
            fused_chunk=True, require_fused=True)
LOOP = {"qps.solve", "qps.factor", "qps.chunk", "qps.check", "qps.sync"}


def _case(name):
    """(problem, settings, solve, the loop's counters, spans wanted)."""
    g = torch.Generator().manual_seed(3)
    if name == "prox":
        prob = device_prox_fleet(4, 128, 64, 64, generator=g)
        return (prob, pt.ProxQPSettings(**PROX), pt.solve_proxqp,
                proxqp._solve_impl, LOOP | {"qps.pad"})
    if name == "admm_fused":
        qp, st, want = device_random_qp_fleet(4, 128, 128, generator=g), FUSED, LOOP
    elif name == "admm_padded":
        qp = device_random_qp_fleet(4, 120, 60, generator=g)
        st, want = FUSED, LOOP | {"qps.pad"}
    elif name == "admm_defaults":
        qp, st, want = device_random_qp_fleet(4, 16, 8, generator=g), {}, LOOP
    else:  # Anderson steps and a polish on the default route
        qp = device_random_qp_fleet(4, 16, 8, generator=g)
        st = dict(anderson_memory=3, polish_iterations=5)
        want = LOOP | {"qps.anderson", "qps.polish"}
    return qp, pt.Settings(**st), pt.solve, admm._solve_core, want


CASES = ["admm_fused", "admm_padded", "admm_defaults", "admm_anderson_polish",
         "prox"]


def _spans(events):
    return sorted((e for e in events if e.key.startswith("qps.")),
                  key=lambda e: (e.time_range.start, -e.time_range.end))


@pytest.mark.parametrize("case", CASES)
def test_a_traced_solve_records_its_layers_as_nested_host_spans(case):
    prob, st, solve, counter, want = _case(case)
    solve(prob, st)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve(prob, st)
    spans = _spans(prof.events())
    assert want <= {e.key for e in spans}, {e.key for e in spans}
    top = [e for e in spans if e.key == "qps.solve"]
    assert len(top) == 1 and spans[0] is top[0]
    # Host events, not user annotations (which the profiler also copies
    # onto the device timeline).
    assert all(not e.is_user_annotation and e.scope == 0 for e in spans)
    # Nested in time: each span lies inside the solve's, and any two are
    # either disjoint or one inside the other.
    open_ = []
    for e in spans:
        r = e.time_range
        while open_ and open_[-1].end <= r.start:
            open_.pop()
        assert not open_ or r.end <= open_[-1].end, e.key
        open_.append(r)
    # The check holds only the check: the pad and the polish lie outside
    # every qps.check.
    checks = [e.time_range for e in spans if e.key == "qps.check"]
    for e in spans:
        if e.key in ("qps.pad", "qps.polish"):
            r = e.time_range
            assert all(r.end <= c.start or c.end <= r.start
                       for c in checks), e.key


@pytest.mark.parametrize("case", ["admm_fused", "admm_defaults", "prox"])
def test_no_profiler_no_record_function(case, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span entered _RecordFunctionFast untraced")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    prob, st, solve, _, _ = _case(case)
    sol = solve(prob, st)
    assert sol.x.isfinite().all()
    assert profiling.span("qps.solve") is profiling._OFF
    assert profiling.span("qps.sync") is profiling._OFF


@pytest.mark.parametrize("name", ["qps.check", "qps.sync"])
def test_span_records_only_under_a_profiler(name):
    assert profiling.span(name) is profiling._OFF
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span(name):
            torch.ones(2).sum()
    (e,) = [e for e in prof.events() if e.key == name]
    assert not e.is_user_annotation and e.scope == 0
    assert {"aten::ones", "aten::sum"} <= {c.key for c in e.cpu_children}


@pytest.mark.parametrize("case", ["admm_fused", "admm_defaults", "prox"])
def test_the_loop_counters(case, monkeypatch):
    """.syncs rises by one a read of the loop's flags in both families, and
    the prox loop's .solves by one a solve."""
    prob, st, solve, counter, _ = _case(case)
    mod = proxqp if counter is proxqp._solve_impl else admm
    reads = []
    real = mod.read_flags

    def counted(flags):
        reads.append(flags)
        return real(flags)

    monkeypatch.setattr(mod, "read_flags", counted)
    syncs0 = counter.syncs
    solves0 = getattr(counter, "solves", 0)
    for _ in range(2):
        solve(prob, st)
    assert len(reads) >= 2 and counter.syncs - syncs0 == len(reads)
    if counter is proxqp._solve_impl:
        assert counter.solves - solves0 == 2
