"""run.py's whole run on every cell at a small size on the CPU, and its
refusals."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from conftest import CELLS, ROOT, small
from qpbench import harness


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_and_is_correct(cell, trace, no_card):
    line, err = harness.run_cell(cell, 2**31 + 11, 0.3, bool(trace),
                                 t_start=time.perf_counter(), device=no_card,
                                 overrides=small(cell))
    spec = harness.load_cell(cell)
    assert line["correct"] is True, err
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    want = spec.per_layer if trace else spec.end_to_end
    # On the CPU the trace holds no device events: only the counters read.
    names = {m["name"] for m in want if m["source"] != "device_trace"}
    names.discard("solve_ms.p95")   # wants 20 solves in the window
    names -= {"peak_device_gb", "peak_device_gb.defaults"}  # a card's allocator
    assert names <= set(line["metrics"]), (names, line["metrics"])
    assert set(line["metrics"]) <= {m["name"] for m in want}
    for m in want:
        if m["name"] in line["metrics"]:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
    assert set(line["checks"]) == {"kkt_ratio"}
    assert err[-1].startswith("check kkt_ratio")
    json.dumps(line)




def test_run_refuses_without_a_card(no_card, capsys):
    from qpbench import run

    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA card" in out.err


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "qpbench", tmp_path / "qpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "qpbench/run.py", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_a_metric_without_a_reader_of_its_own_reads_as_its_prefix():
    assert harness.reader("qp_per_s.defaults").__file__.endswith("qp_per_s.py")
    assert harness.reader("lane_iters.max.defaults").__file__.endswith(
        "lane_iters.max.py")
    assert harness.reader("solve_ms.p95").__file__.endswith("solve_ms.p95.py")
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.defaults")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]).read), m["name"]
