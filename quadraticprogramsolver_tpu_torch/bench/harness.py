"""Benchmark harness — sweep, timing, and CSV/JSONL results emitter
(counterpart of the JAX package's bench/harness.py).

Re-creates the reference's BenchmarkTools-based harness (RunBenchmarks.jl):
a sweep over problem classes x sizes x simulations (:88-90), per-case
best-of-N timing (:98-99), convergence flag recording (:104), and a CSV
results file with a metadata header (solver label, version, hardware, UTC
date — :59-62) and a schema-equality guard on append (:123-137). JSONL output
is added for machine consumption.

The columns, fields, guards and default settings are the JAX package's, so a
CSV or JSONL file written by either package can be appended to by the other.
The default label is "qps-torch", which keeps the two packages' rows apart in
one file, and the device column names the card with its power limit
(``nvidia-smi``), so every time in a record stands beside the card that took
it.

Timing: wall clock around one ``solve``, after a warm call that absorbs the
kernels' first use; each timed call ends in ``torch.cuda.synchronize()``
when the QP is on the card. The fleet is made on the card unless the caller
passes ``device="cpu"``; without a card and without it, :func:`run_case`
raises.
"""

from __future__ import annotations

import csv
import dataclasses
import datetime
import json
import os
import subprocess
import time
from typing import Sequence

import numpy as np
import torch

from .. import __version__
from ..core.problem import default_device, pad_qp
from ..core.settings import Settings
from ..models.admm import solve
from ..problems.generator import ALL_CLASSES, ProblemClass, generate_batch

CSV_COLUMNS = [
    "label", "version", "device", "date_utc",
    "problem_class", "num_elements", "num_constraints", "batch",
    "best_time_sec", "mean_time_sec", "solved", "total",
    "solves_per_sec", "iterations_per_sec", "median_iterations",
]

#: The label of this package's rows (the JAX package writes "qps-tpu").
LABEL = "qps-torch"


@dataclasses.dataclass
class BenchCase:
    problem_class: ProblemClass
    num_elements: int
    num_constraints: int = 0
    batch: int = 64
    #: Optional (n_pad, m_pad): zero-pad instances to a shared static shape
    #: (pad_qp), as the JAX package does to reuse one compiled executable.
    pad_to: tuple | None = None


@dataclasses.dataclass
class BenchResult:
    case: BenchCase
    best_time_sec: float
    mean_time_sec: float
    solved: int
    total: int
    solves_per_sec: float
    iterations_per_sec: float
    median_iterations: float


def _device_label(device=None) -> str:
    """"gpu:<name>, <power limit>" for a card, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` reads them for it
    ("gpu:<name>" where nvidia-smi cannot be read); "cpu:cpu" on the CPU.
    ``device`` None: the card when there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return f"{device.type}:{device.type}"
    index = torch.cuda.current_device() if device.index is None else device.index
    props = torch.cuda.get_device_properties(index)
    uuid = str(getattr(props, "uuid", "")).removeprefix("GPU-")
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        rows = [ln.split(", ", 1) for ln in out.stdout.strip().splitlines()]
        # The card by its UUID; by its index where the UUIDs do not match.
        match = [rest for u, rest in rows if u.removeprefix("GPU-") == uuid]
        return f"gpu:{match[0] if match else rows[index][1]}"
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return f"gpu:{props.name}"


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def time_solve(qp, settings: Settings, samples: int = 3):
    """One warm call, then ``samples`` timed solves; returns (times, sol)."""
    sol = solve(qp, settings)
    _sync(sol.x)
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        sol = solve(qp, settings)
        _sync(sol.x)
        times.append(time.perf_counter() - t0)
    return times, sol


def run_case(case: BenchCase, settings: Settings, seed: int = 1234,
             samples: int = 3, dtype=np.float32, device=None) -> BenchResult:
    """Generate the case's fleet on ``device`` (the card unless
    ``device="cpu"``; raises without one), pad it when ``case.pad_to`` says
    so, and time its solve."""
    device = default_device(device)
    qp = generate_batch(case.problem_class, case.batch, case.num_elements,
                        case.num_constraints, seed=seed, dtype=dtype,
                        device=device)
    if case.pad_to is not None:
        qp = pad_qp(qp, *case.pad_to)
    times, sol = time_solve(qp, settings, samples)
    status = sol.info.status.cpu().numpy()
    iters = sol.info.iterations.cpu().numpy()
    # Solved means converged (flags 2/3) — NOT detected-infeasible (4/5).
    solved = int(((status == 2) | (status == 3)).sum())
    best = min(times)
    return BenchResult(
        case=case,
        best_time_sec=best,
        mean_time_sec=float(np.mean(times)),
        solved=solved,
        total=case.batch,
        solves_per_sec=solved / best if best > 0 else 0.0,
        iterations_per_sec=float(iters.sum()) / best if best > 0 else 0.0,
        median_iterations=float(np.median(iters)),
    )


def default_sweep(small: int = 20, large: int = 100, batch: int = 64) -> list[BenchCase]:
    """9 classes x 2 sizes, mirroring the RunBenchmarks.jl grid (:88-90).

    The m=100n families get capped constraint counts (as in the tests) so
    the dense sweep stays tractable; the paper-default ratios remain
    available by passing num_constraints=0.
    """
    capped = {ProblemClass.LASSO: 60, ProblemClass.HUBER: 60,
              ProblemClass.SVM: 60, ProblemClass.INEQUALITY_QP: 60}
    cases = []
    for cls in ALL_CLASSES:
        for n in (small, large):
            cases.append(BenchCase(cls, n, capped.get(cls, 0), batch))
    return cases


def _meta(label: str, device) -> dict:
    return {
        "label": label,
        "version": __version__,
        "device": _device_label(device),
        "date_utc": datetime.datetime.now(datetime.UTC).isoformat(timespec="seconds"),
    }


def emit_results(results: Sequence[BenchResult], csv_path: str | None = None,
                 jsonl_path: str | None = None, label: str = LABEL,
                 device=None) -> None:
    """Append results with metadata; guard against schema drift on append
    (the reference's header-equality check, RunBenchmarks.jl:123-137).
    ``device``: where the results were measured, for the device column
    (:func:`_device_label`)."""
    meta = _meta(label, device)
    rows = []
    for r in results:
        rows.append({
            **meta,
            "problem_class": r.case.problem_class.value,
            "num_elements": r.case.num_elements,
            "num_constraints": r.case.num_constraints,
            "batch": r.case.batch,
            "best_time_sec": f"{r.best_time_sec:.6g}",
            "mean_time_sec": f"{r.mean_time_sec:.6g}",
            "solved": r.solved,
            "total": r.total,
            "solves_per_sec": f"{r.solves_per_sec:.6g}",
            "iterations_per_sec": f"{r.iterations_per_sec:.6g}",
            "median_iterations": r.median_iterations,
        })
    if csv_path:
        exists = os.path.exists(csv_path)
        if exists:
            with open(csv_path) as f:
                header = next(csv.reader(f), None)
            if header != CSV_COLUMNS:
                raise ValueError(
                    f"existing CSV schema {header} != current {CSV_COLUMNS}; "
                    "refusing to append (schema guard)")
        with open(csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
            if not exists:
                w.writeheader()
            w.writerows(rows)
    if jsonl_path:
        with open(jsonl_path, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


def append_headline_record(jsonl_path: str, record: dict,
                           label: str = LABEL, device=None) -> dict:
    """Append one headline-config record (full config + audit + throughput)
    to a JSONL artifact with the same metadata columns as the CSV harness
    and a key-set guard against the file's last record of the same family —
    the JSON analogue of the reference's CSV header-equality check
    (RunBenchmarks.jl:123-137).
    """
    row = {**_meta(label, device), **record}
    # Guard per row FAMILY (the "bench"/"benchmark" tag): one artifact may
    # hold several benches' rows; schema drift is checked against the last
    # row of the SAME family. A strict superset of its keys (new diagnostic
    # columns) is allowed; dropped columns refuse.
    fam = row.get("bench") or row.get("benchmark")
    if os.path.exists(jsonl_path):
        with open(jsonl_path) as f:
            lines = [ln for ln in f if ln.strip()]
        prev = None
        for ln in reversed(lines):
            r = json.loads(ln)
            if (r.get("bench") or r.get("benchmark")) == fam:
                prev = r
                break
        if prev is not None and not set(prev) <= set(row):
            raise ValueError(
                f"existing record schema {sorted(prev)} is not a subset of "
                f"current {sorted(row)}; refusing to append (schema guard)")
    with open(jsonl_path, "a") as f:
        f.write(json.dumps(row) + "\n")
    return row


def run_sweep(cases: Sequence[BenchCase] | None = None,
              settings: Settings | None = None,
              csv_path: str | None = None, jsonl_path: str | None = None,
              seed: int = 1234, samples: int = 3, dtype=np.float32,
              verbose: bool = True, device=None) -> list[BenchResult]:
    cases = default_sweep() if cases is None else cases
    settings = settings or Settings(
        max_iterations=4000, eps_abs=1e-4, eps_rel=1e-4, rho=0.1,
        adaptive_rho=True)
    device = default_device(device)
    results = []
    for case in cases:
        r = run_case(case, settings, seed=seed, samples=samples, dtype=dtype,
                     device=device)
        results.append(r)
        if verbose:
            print(
                f"{case.problem_class.value:>16} n={case.num_elements:<5} "
                f"B={case.batch:<5} {r.best_time_sec*1e3:8.1f} ms  "
                f"{r.solves_per_sec:10.0f} solves/s  "
                f"{r.iterations_per_sec:12.0f} iter/s  "
                f"solved {r.solved}/{r.total}")
    if csv_path or jsonl_path:
        emit_results(results, csv_path, jsonl_path, device=device)
    return results
