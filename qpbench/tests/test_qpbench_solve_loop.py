"""The solve loop's readers: the idle time the trace puts down to the
program's spans, and the prox loop's syncs per solve."""

import pytest

from qpbench import harness, tracing


def _run(idle_gaps, solves=4, cell="admm_rqp.n512.b4096.fused"):
    spec = harness.load_cell(cell, {"batch": 2, "shape": {"n": 4, "m": 2}})
    run = harness.Run(cell=spec, setup_s=1.0)
    run.trace = tracing.Trace(solves=solves, window_s=1.0, busy_s=0.8,
                              device_ms={"k": 1.0}, idle_gaps=idle_gaps)
    return run


def test_idle_ms_sums_the_spans_gaps_only():
    idle = harness.reader("solve_loop.idle_ms")
    run = _run([("cudaLaunchKernel", 0.020), ("qps.chunk", 0.010),
                ("(no host event)", 0.008), ("qps.check", 0.004),
                ("aten::mul", 0.003), ("qps.sync", 0.002),
                ("qps_not_a_span", 0.5)])
    assert idle.read(run) == pytest.approx(1e3 * 0.016 / 4)
    assert [n for n in run.notes if n.startswith("idle under qps.")] == [
        "idle under qps.chunk: 2.5000 ms a solve",
        "idle under qps.check: 1.0000 ms a solve",
        "idle under qps.sync: 0.5000 ms a solve"]


@pytest.mark.parametrize("gaps", [[], [("(no host event)", 0.03),
                                       ("cudaStreamSynchronize", 0.01)]])
def test_idle_ms_without_a_span_in_the_ten(gaps, monkeypatch):
    """A program with spans reads 0 where no span made the trace's ten
    names, so the line keeps the metric; one without spans, or a run
    without a trace, reads nothing."""
    from quadraticprogramsolver_tpu_torch.utils import profiling

    idle = harness.reader("solve_loop.idle_ms")
    assert idle.read(_run(gaps)) == 0.0
    run = _run(gaps)
    run.trace = None
    assert idle.read(run) is None
    monkeypatch.delattr(profiling, "span")
    assert idle.read(_run(gaps)) is None


def test_the_defaults_cell_reads_idle_ms_as_its_prefix():
    assert harness.reader("solve_loop.idle_ms.defaults").__file__.endswith(
        "solve_loop.idle_ms.py")


def test_prox_syncs_per_solve_read_the_program_counters(monkeypatch):
    from quadraticprogramsolver_tpu_torch.models import proxqp

    syncs = harness.reader("host_syncs_per_solve.prox")
    run = _run([], cell="prox.n512.b4096.fused")
    monkeypatch.setattr(proxqp._solve_impl, "syncs", 18)
    monkeypatch.setattr(proxqp._solve_impl, "solves", 9)
    assert syncs.read(run) == 2.0
    monkeypatch.setattr(proxqp._solve_impl, "solves", 0)
    assert syncs.read(run) is None
    # A program without the counters reads nothing.
    monkeypatch.delattr(proxqp._solve_impl, "syncs")
    assert syncs.read(run) is None
