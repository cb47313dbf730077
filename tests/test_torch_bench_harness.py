"""The port's benchmark harness (bench/harness.py) against the JAX package's,
and the port-side examples (examples/*_torch.py): the JAX harness tests
mirrored on the port, f64 parity of run_case, CSV and JSONL files crossing
between the packages both ways, the card rule, and each example's main() at
a tiny size on the CPU."""

import csv
import dataclasses
import importlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.bench import harness as jax_harness

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.bench import harness
from quadraticprogramsolver_tpu_torch.bench.harness import (
    CSV_COLUMNS, BenchCase, append_headline_record, emit_results, run_case,
    run_sweep)

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"

FAST = dict(max_iterations=500, eps_abs=1e-4, eps_rel=1e-4, rho=0.1,
            adaptive_rho=True)
PT_FAST = pt.Settings(**FAST)


def test_run_case_and_emit(tmp_path):
    case = BenchCase(pt.ProblemClass.RANDOM_QP, num_elements=16, batch=8)
    r = run_case(case, PT_FAST, samples=2, dtype=np.float64, device="cpu")
    assert r.total == 8 and 0 <= r.solved <= 8
    assert r.best_time_sec > 0
    assert r.solves_per_sec > 0

    csv_path = tmp_path / "bench.csv"
    jsonl_path = tmp_path / "bench.jsonl"
    emit_results([r], str(csv_path), str(jsonl_path), device="cpu")
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    assert rows[0]["problem_class"] == "random_qp"
    assert rows[0]["version"] == pt.__version__
    assert rows[0]["label"] == "qps-torch"
    assert rows[0]["device"] == "cpu:cpu"
    with open(jsonl_path) as f:
        rec = json.loads(f.readline())
    assert rec["batch"] == 8

    # Append keeps the schema; a drifted schema must be refused.
    emit_results([r], str(csv_path), device="cpu")
    with open(csv_path) as f:
        assert len(list(csv.DictReader(f))) == 2
    bad = tmp_path / "bad.csv"
    with open(bad, "w") as f:
        f.write("wrong,schema\n1,2\n")
    with pytest.raises(ValueError, match="schema"):
        emit_results([r], str(bad), device="cpu")


def test_small_sweep(tmp_path):
    cases = [
        BenchCase(pt.ProblemClass.RANDOM_QP, 12, batch=4),
        BenchCase(pt.ProblemClass.ISOTONIC, 12, batch=4),
    ]
    results = run_sweep(cases, PT_FAST, samples=1, dtype=np.float64,
                        jsonl_path=str(tmp_path / "s.jsonl"), verbose=False,
                        device="cpu")
    assert len(results) == 2
    assert all(r.best_time_sec > 0 for r in results)
    with open(tmp_path / "s.jsonl") as f:
        assert [json.loads(ln)["device"] for ln in f] == ["cpu:cpu"] * 2


def test_headline_record_schema_guard(tmp_path):
    path = str(tmp_path / "headline.jsonl")
    rec = append_headline_record(path, {"batch": 4096, "value": 11490.0},
                                 device="cpu")
    assert rec["batch"] == 4096
    assert {"label", "version", "device", "date_utc"} <= set(rec)
    append_headline_record(path, {"batch": 3072, "value": 10651.0})
    with open(path) as f:
        rows = [json.loads(ln) for ln in f]
    assert [r["batch"] for r in rows] == [4096, 3072]
    with pytest.raises(ValueError, match="schema guard"):
        append_headline_record(path, {"batch": 2048, "extra_key": 1.0})
    # Additive columns (strict superset) are allowed; dropped ones refuse.
    append_headline_record(path, {"batch": 1024, "value": 1.0,
                                  "new_diag": 2.0})
    # Rows of a DIFFERENT bench family in the same file are guarded apart.
    append_headline_record(path, {"bench": "defaults", "value": 3.0})
    append_headline_record(path, {"bench": "defaults", "value": 4.0})
    append_headline_record(path, {"benchmark": "baseline", "value": 5.0})
    with pytest.raises(ValueError, match="schema guard"):
        append_headline_record(path, {"bench": "defaults", "other": 5.0})


def test_names_columns_and_sweep_match_jax():
    public = {k for k, v in vars(jax_harness).items()
              if not k.startswith("_") and callable(v)
              and getattr(v, "__module__", "") == jax_harness.__name__}
    public |= {"CSV_COLUMNS"}
    assert public <= set(vars(harness)), public - set(vars(harness))
    assert harness.CSV_COLUMNS == jax_harness.CSV_COLUMNS
    for cls in (BenchCase, harness.BenchResult):
        jcls = getattr(jax_harness, cls.__name__)
        assert ([(f.name, f.default) for f in dataclasses.fields(cls)]
                == [(f.name, f.default) for f in dataclasses.fields(jcls)])
    port = [(c.problem_class.value, c.num_elements, c.num_constraints,
             c.batch, c.pad_to) for c in harness.default_sweep()]
    ref = [(c.problem_class.value, c.num_elements, c.num_constraints,
            c.batch, c.pad_to) for c in jax_harness.default_sweep()]
    assert port == ref and len(port) == 18
    assert harness._device_label("cpu") == jax_harness._device_label() == "cpu:cpu"


@pytest.mark.parametrize("cls,n,batch,pad_to", [
    ("RANDOM_QP", 16, 8, None), ("ISOTONIC", 12, 4, None),
    ("RANDOM_QP", 16, 4, (20, 12))])
def test_run_case_parity_f64(cls, n, batch, pad_to):
    """The same case, seed and settings through both packages' run_case in
    f64: the same solved, total and median iterations."""
    j = jax_harness.run_case(
        jax_harness.BenchCase(qps.ProblemClass[cls], n, batch=batch,
                              pad_to=pad_to),
        qps.Settings(**FAST), seed=7, samples=1, dtype=np.float64)
    p = run_case(BenchCase(pt.ProblemClass[cls], n, batch=batch,
                           pad_to=pad_to),
                 PT_FAST, seed=7, samples=1, dtype=np.float64, device="cpu")
    assert (p.solved, p.total, p.median_iterations) == (
        j.solved, j.total, j.median_iterations)
    assert p.solved > 0


@pytest.fixture(scope="module")
def one_result():
    return run_case(BenchCase(pt.ProblemClass.ISOTONIC, 12, batch=4),
                    PT_FAST, samples=1, dtype=np.float64, device="cpu")


def _jax_result(r):
    case = jax_harness.BenchCase(qps.ProblemClass(r.case.problem_class.value),
                                 r.case.num_elements, r.case.num_constraints,
                                 r.case.batch)
    return jax_harness.BenchResult(case, *(getattr(r, f.name) for f in
                                           dataclasses.fields(r)[1:]))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_files_cross_between_packages(tmp_path, one_result, first):
    """A CSV and a headline JSONL written by either package are appended to
    by the other without a guard error; the labels keep the rows apart."""
    writers = {
        "jax": (lambda c, j: jax_harness.emit_results(
                    [_jax_result(one_result)], c, j),
                lambda p, rec: jax_harness.append_headline_record(p, rec)),
        "port": (lambda c, j: emit_results([one_result], c, j, device="cpu"),
                 lambda p, rec: append_headline_record(p, rec, device="cpu")),
    }
    order = [first, "port" if first == "jax" else "jax"]
    csv_path, jsonl_path = str(tmp_path / "b.csv"), str(tmp_path / "b.jsonl")
    head = str(tmp_path / "h.jsonl")
    for who in order:
        emit, headline = writers[who]
        emit(csv_path, jsonl_path)
        headline(head, {"bench": "headline", "batch": 4, "value": 1.0})
    with open(csv_path) as f:
        header = next(csv.reader(f))
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    assert header == CSV_COLUMNS
    labels = {"jax": "qps-tpu", "port": "qps-torch"}
    assert [r["label"] for r in rows] == [labels[w] for w in order]
    for path in (jsonl_path, head):
        with open(path) as f:
            assert [json.loads(ln)["label"] for ln in f] == [
                labels[w] for w in order]


def test_drifted_files_are_refused_by_both(tmp_path, one_result):
    bad_csv = tmp_path / "bad.csv"
    bad_csv.write_text(",".join(CSV_COLUMNS[:-1]) + "\n")
    with pytest.raises(ValueError, match="schema guard"):
        emit_results([one_result], str(bad_csv), device="cpu")
    with pytest.raises(ValueError, match="schema guard"):
        jax_harness.emit_results([_jax_result(one_result)], str(bad_csv))
    head = str(tmp_path / "h.jsonl")
    append_headline_record(head, {"batch": 4, "value": 1.0}, device="cpu")
    jax_harness.append_headline_record(head, {"batch": 4, "value": 1.0})
    with pytest.raises(ValueError, match="schema guard"):
        append_headline_record(head, {"batch": 4}, device="cpu")
    with pytest.raises(ValueError, match="schema guard"):
        jax_harness.append_headline_record(head, {"batch": 4})


def test_run_case_without_card_raises(monkeypatch):
    """The fleet goes to the card unless the caller asks for the CPU; with
    no card and no device="cpu", run_case and run_sweep raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = BenchCase(pt.ProblemClass.RANDOM_QP, 8, batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_case(case, PT_FAST)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep([case], PT_FAST, verbose=False)
    assert harness._device_label() == "cpu:cpu"


def _example(name):
    sys.path.insert(0, str(EXAMPLES))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(EXAMPLES))


def _statuses(out):
    """Every status tensor in an example's result."""
    sols = out.values() if isinstance(out, dict) else [out]
    return [s.info.status for s in sols]


@pytest.mark.parametrize("name,kw,converged", [
    ("portfolio_fleet_torch", dict(fleet_size=4, assets=10), (2, 3)),
    ("prox_fleet_torch", dict(B=4, n=16, me=2, mi=4), (3,)),
    ("monotone_smoothing_torch", dict(n=40), (3,)),
    ("mpc_fleet_torch", dict(B=4, T=3, H=8, H2=16, B2=4, H3=16, B3=4, T3=2),
     (2, 3)),
    ("anderson_acceleration_torch", dict(batch=4, n=10), (2, 3)),
    ("diagnostics_report_torch", dict(n=10), (2, 3)),
])
def test_example_runs_on_cpu(tmp_path, capsys, name, kw, converged):
    mod = _example(name)
    if name == "diagnostics_report_torch":
        kw = dict(kw, out=str(tmp_path / "report"))
    out = mod.main(device="cpu", **kw)
    for status in _statuses(out):
        assert status.device.type == "cpu"
        assert bool(torch.isin(status, torch.tensor(converged)).all()), status
    printed = capsys.readouterr().out
    assert printed.strip()
    if name == "diagnostics_report_torch":
        assert (tmp_path / "report.txt").read_text() in printed


def test_examples_default_to_the_card(monkeypatch):
    """Without device="cpu" an example builds on the card, and raises here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, kw in (("portfolio_fleet_torch", dict(fleet_size=2, assets=5)),
                     ("prox_fleet_torch", {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _example(name).main(**kw)
