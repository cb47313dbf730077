"""A whole run with the timed path broken underneath comes out not correct:
once for each fault that a one-card solver cell can have (no cell has an
exchange between cards), and once with the program given a tighter problem
than the one it is judged on, whose answer is feasible and stationary for
the problem made and fails only its complementarity."""

import time

import pytest

from conftest import CELLS, small
from qpbench import harness


def _run(cell, device):
    line, _ = harness.run_cell(cell, 2**31 + 21, 0.2, False,
                               t_start=time.perf_counter(), device=device,
                               overrides=small(cell))
    return line


def _unchanged_step(monkeypatch, cell):
    """Every chunk of iterations hands back the state it was given."""
    from quadraticprogramsolver_tpu_torch.models import admm, proxqp

    if harness.load_cell(cell).config["family"] == "admm":
        real = admm._run_chunk

        def stuck(qp, settings, backend, state):
            out = real(qp, settings, backend, state)
            return (state.x, state.z, state.y, state.x, state.z, out[5], None)

        monkeypatch.setattr(admm, "_run_chunk", stuck)
    else:
        real = proxqp.fused_proxqp_chunk

        def stuck(G, A, C, g, b, d, x, s, y, z, *args, **kw):
            real(G, A, C, g, b, d, x, s, y, z, *args, **kw)
            return x, s, y, z

        monkeypatch.setattr(proxqp, "fused_proxqp_chunk", stuck)


def _wrap_solve(monkeypatch, change):
    """The family's solve, with ``change(problem, solution)`` applied to
    what it returns."""
    real = harness.family

    def family(config):
        Problem, Settings, solve, names = real(config)

        def broken(prob, settings):
            return change(prob, solve(prob, settings))

        return Problem, Settings, broken, names

    monkeypatch.setattr(harness, "family", family)


def _half_left_out(monkeypatch, cell):
    """Only the first half of the fleet is solved; the rest is handed back
    as the start point with the first half's statuses."""
    def change(prob, sol):
        h = sol.x.shape[0] // 2
        for t in (sol.x, sol.y, sol.z):
            t[h:] = 0.0
        sol.info.status[h:] = sol.info.status[:h]
        return sol

    _wrap_solve(monkeypatch, change)


def _answer_altered(monkeypatch, cell):
    """One lane's x is moved by 1e-2 where the solve produces it."""
    def change(prob, sol):
        sol.x[1, 0] += 1e-2
        return sol

    _wrap_solve(monkeypatch, change)


def _bounds_tightened(monkeypatch, cell):
    """The solver is handed the fleet with its bounds moved inward
    (control.tighten), and judged on the fleet as made."""
    from qpbench import control

    real = harness.family

    def family(config):
        Problem, Settings, solve, names = real(config)

        def tight(**f):
            return Problem(**control.tighten(config["form"], f))

        return tight, Settings, solve, names

    monkeypatch.setattr(harness, "family", family)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_left_out, _answer_altered,
                                   _bounds_tightened])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch, no_card):
    assert _run(cell, no_card)["correct"] is True
    fault(monkeypatch, cell)
    line = _run(cell, no_card)
    assert line["correct"] is False, line["checks"]
