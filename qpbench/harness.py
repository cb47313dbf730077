"""One run of one cell: make the fleets (one pool of problems, in the
seed's order and turned by the seed's signs: ``make_fleet``), warm up, run
the closed loop for the window, trace a few solves (``--trace 1``), judge
the answers, and build the result line.

A cell is found by name in BENCHMARK.json; its configuration file gives the
family, the generator and the accuracy the configuration states, its
traffic file (``workloads/<traffic>.json``) the batch, the shape, the rest
of the settings stack, the fleets in the rotation, the seed of their pool
and the limit of the comparison. Each metric is computed
by ``metrics/<name>.py``'s ``read(run)`` (see ``reader``), which returns None
where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "qpbench"
#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "quadraticprogramsolver_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell of BENCHMARK.json with its configuration and traffic."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # the metric entries this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ROOT/BENCHMARK.json; ``overrides`` replace
    top-level keys of its traffic (the CPU rehearsal's small sizes)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"known: {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = load_json(HERE / "workloads" / f"{w['traffic']}.json")
    traffic.update(overrides or {})
    return Cell(name=name, chips=w["chips"],
                config=load_json(ROOT / cfg["file"]), traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "qpbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The module of ``metrics/<metric>.py`` or, where there is none, of the
    longest dotted prefix of ``metric`` that has one: a metric that only
    carries another name (``qp_per_s.defaults``, whose bound differs, and
    the per-layer metrics that move it) reads as its prefix does."""
    name = metric
    while not (HERE / "metrics" / f"{name}.py").is_file():
        if "." not in name:
            raise FileNotFoundError(f"no reader for metric {metric!r} in "
                                    f"{HERE / 'metrics'}")
        name = name.rsplit(".", 1)[0]
    return load_module(HERE / "metrics" / f"{name}.py")


#: The streams that ``derived_seed`` keeps apart.
POOL, ORIENT, ROTATION = 0, 1, 2


def derived_seed(seed: int, stream: int, k: int = 0) -> int:
    """A 63-bit seed for item k of a stream of seed ``seed``."""
    s = np.random.SeedSequence([seed % 2**64, stream, k]).generate_state(2, np.uint32)
    return (int(s[0]) << 31) ^ int(s[1])


@dataclasses.dataclass
class Run:
    """What the readers read."""

    cell: Cell
    setup_s: float
    window_s: float = 0.0
    solve_ms: list = dataclasses.field(default_factory=list)
    attempted: int = 0
    converged: int = 0
    lane_iters_max: list = dataclasses.field(default_factory=list)
    syncs: int | None = None          # the program's host-sync counter
    peak_bytes: int = 0
    trace: object = None              # tracing.Trace of the traced solves
    traced_iterations: list = dataclasses.field(default_factory=list)
    notes: list = dataclasses.field(default_factory=list)

    @property
    def shape(self) -> dict:
        return self.cell.traffic["shape"]

    @property
    def batch(self) -> int:
        return self.cell.traffic["batch"]

    def kernels_of(self, metric: str) -> tuple:
        """The kernel names that ``metrics/<metric>.py`` maps to its
        layer."""
        return tuple(reader(metric).KERNELS)

    def note(self, text: str) -> None:
        """A line for standard error beside the metrics."""
        self.notes.append(text)


def card_state() -> str:
    """The card's name, power limit and draw, SM clock (and its maximum) and
    temperature as nvidia-smi reads them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "-i", "0", "--format=csv,noheader", "--query-gpu="
             "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"],
            capture_output=True, text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def family(config: dict):
    """(problem class, settings class, solve, output names) of the
    configuration's solver family in the port."""
    import quadraticprogramsolver_tpu_torch as pkg

    if config["family"] == "admm":
        return pkg.QP, pkg.Settings, pkg.solve, ("x", "z", "y")
    if config["family"] == "prox":
        return pkg.ProxQPProblem, pkg.ProxQPSettings, pkg.solve_proxqp, ("x", "y", "z")
    raise ValueError(f"unknown family {config['family']!r}")


def solver(cell: Cell):
    """(problem class, settings, solve, output names) of the cell: the
    configuration's accuracy and the traffic's settings stack."""
    Problem, Settings, solve, names = family(cell.config)
    settings = Settings(eps_abs=cell.config["eps_abs"],
                        eps_rel=cell.config["eps_rel"], **cell.traffic["settings"])
    return Problem, settings, solve, names


def sync_counter(config: dict):
    """The program's host-sync counter of this family's solve loop, or None
    where the loop keeps none."""
    if config["family"] != "admm":
        return None
    from quadraticprogramsolver_tpu_torch.models import admm

    return admm._solve_core


def rotation(cell: Cell, seed: int) -> list[int]:
    """The order in which run seed ``seed`` takes the pool's fleets."""
    rng = np.random.default_rng(derived_seed(seed, ROTATION))
    return [int(j) for j in rng.permutation(cell.traffic["fleets"])]


def make_fleet(cell: Cell, seed: int, k: int, device: str) -> dict:
    """Fleet k of run seed ``seed``, made on ``device``.

    Every seed solves one pool of problems, so that every seed does the same
    work: a fleet solve lasts as long as its slowest lane, and fleets drawn
    anew from each seed differ by whole chunks of iterations. Pool fleet j is
    drawn by the configuration's generator from the traffic's ``pool_seed``;
    run seed ``seed`` takes the pool's fleets in an order of its own
    (``rotation``) and turns each lane by signs of its own (the generator's
    ``orient``): the inputs are other bits, the problems and their work the
    same."""
    import torch

    gen = load_module(HERE / "traffic" / f"{cell.config['generator']}.py")
    j = rotation(cell, seed)[k]
    g = torch.Generator(device=device)
    g.manual_seed(derived_seed(cell.traffic["pool_seed"], POOL, j))
    f = gen.fleet(cell.traffic["batch"], **cell.traffic["shape"], generator=g)
    g.manual_seed(derived_seed(seed, ORIENT, k))
    return gen.orient(f, generator=g)


def make_fleets(cell: Cell, seed: int, device: str) -> list[dict]:
    """The cell's fleets of run seed ``seed``."""
    return [make_fleet(cell, seed, k, device) for k in range(cell.traffic["fleets"])]


def outputs(sol, out_names) -> dict:
    """A solution's primal-dual point, statuses and iterations by name."""
    out = {a: getattr(sol, a) for a in out_names}
    return dict(out, status=sol.info.status, iterations=sol.info.iterations)


def compare_fleet(cell: Cell, k: int, fleet: dict, out: dict) -> dict:
    """judge.judge_fleet's numbers for fleet k's answers."""
    from qpbench import judge

    cfg = cell.config
    return judge.judge_fleet(fleet, out, form=cfg["form"],
                             eps_abs=cfg["eps_abs"], eps_rel=cfg["eps_rel"])


def compare(cell: Cell, fleets: list[dict], outs: list[dict]) -> dict:
    """The numbers over every fleet: each the largest of its fleets'."""
    from qpbench import judge

    return judge.worst([compare_fleet(cell, k, f, o)
                        for k, (f, o) in enumerate(zip(fleets, outs))])


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda",
             overrides: dict | None = None) -> tuple[dict, list]:
    """One run; returns (the result line's dict, lines for standard error).
    ``t_start`` is the process's start on the host clock."""
    import torch

    from qpbench import judge, tracing

    cell = load_cell(name, overrides)
    cfg, tr = cell.config, cell.traffic
    Problem, settings, solve, out_names = solver(cell)
    conv_status = torch.tensor(cfg["converged_status"], device=device)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    marks = [("imports", time.perf_counter())]
    fleets = make_fleets(cell, seed, device)
    problems = [Problem(**f) for f in fleets]
    sync()
    marks.append(("fleets", time.perf_counter()))
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def one(k):
        return solve(problems[k], settings)

    one(0)  # every fleet has the one shape: one warm-up solve builds it all
    sync()
    marks.append(("warm-up solve", time.perf_counter()))
    run = Run(cell=cell, setup_s=marks[-1][1] - t_start)
    prev = t_start
    for what, t in marks:
        run.note(f"set-up: {what} {t - prev:.3f} s")
        prev = t

    counter = sync_counter(cfg)
    syncs0 = counter.syncs if counter else None
    conv, iters_max, events, last = [], [], [], {}
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while True:
        k = i % len(problems)
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            sol = one(k)
            e1.record()
            sync()
            events.append((e0, e1))
        else:
            h0 = time.perf_counter()
            sol = one(k)
            events.append(time.perf_counter() - h0)
        status = sol.info.status
        conv.append(torch.isin(status, conv_status).sum())
        iters_max.append(sol.info.iterations.max())
        last[k] = sol
        i += 1
        if i >= len(problems) and time.perf_counter() >= deadline:
            break  # every fleet solved at least once, and the time is up
    run.window_s = time.perf_counter() - t0
    if cuda:
        run.note(f"card after the window: {card_state()}")
    run.solve_ms = [e0.elapsed_time(e1) for e0, e1 in events] if cuda else [
        dt * 1e3 for dt in events]
    run.attempted = i * tr["batch"]
    run.converged = int(torch.stack(conv).sum())
    run.lane_iters_max = torch.stack(iters_max).tolist()
    if counter:
        run.syncs = counter.syncs - syncs0
    run.peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0

    if trace:
        traced_out = []

        def rotation():
            traced_out.clear()
            for k in range(len(problems)):
                traced_out.append(one(k).info.iterations)

        prof, wall = tracing.traced(torch, rotation)
        run.trace = tracing.reduce(prof, wall, len(problems))
        run.traced_iterations = [t.cpu() for t in traced_out]
        del prof

    outs = [outputs(last[k], out_names) for k in range(len(problems))]
    del sol, last, problems
    if cuda:
        torch.cuda.empty_cache()
    numbers = compare(cell, fleets, outs)
    limits = tr["limits"]
    correct = judge.verdict(numbers, limits)

    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        v = reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.attempted - run.converged, "metrics": metrics,
            "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        ops = sorted(run.trace.device_ms.items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {
            "device_ops": [[k, v / 1e3] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in run.trace.idle_gaps]}
    line["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                      for k in limits}
    err = list(run.notes)
    err.append(f"window: {len(run.solve_ms)} solves in {run.window_s:.3f} s, "
               f"solve ms median {statistics.median(run.solve_ms):.3f}")
    err += [f"check {k}: {numbers[k]!r} limit {limits[k]!r}" for k in limits]
    return line, err


def forbidden_modules(modules) -> list[str]:
    """The names in ``modules`` whose top-level name is forbidden here."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)
