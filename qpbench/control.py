"""The control of a cell's comparison, and the program's readings over many
seeds, in one process on the card:

    python3 qpbench/control.py --workload <cell> --control-seeds 11,12,13 \
        [--program-seeds 1,2,...] [--tightened-seeds 21,22,23]

For each seed it makes the cell's fleets as a run does and prints one JSON
line of judge.judge's numbers. For a control seed, those of the control: reference/osqp_batched.py
put in the program's place, at TF32 (the precision next below the FP32 that
the configurations state), at the configuration's accuracy and the cell's
iteration limit, from the reference's own start (rho 0.1, adaptive). The
split form runs as its box form [A; C]. For a program seed, the program's
numbers, one solve a fleet: the readings that a limit is set from. For a
tightened seed, the program given a tighter problem than the one it is
judged on (``tighten``): a point that is feasible and stationary there and
holds multipliers on constraints that are not active. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


#: The share of each box row's width that ``tighten`` takes from either side,
#: and the amount it lowers each split-form d by (d's slack at the fleet's
#: feasible point is 1).
SHRINK = 0.1


def tighten(form: str, f: dict) -> dict:
    """Fleet ``f`` with its bounds moved inward: box rows with l < u lose
    SHRINK of their width at each end (equality rows stay), split-form d is
    lowered by SHRINK. The problem stays feasible and its every feasible
    point is feasible for ``f``."""
    if form == "box":
        w = (f["u"] - f["l"]) * SHRINK
        return dict(f, l=f["l"] + w, u=f["u"] - w)
    return dict(f, d=f["d"] - SHRINK)


def control_output(cell, f) -> dict:
    """The control's answers on fleet ``f``, in the program's output names."""
    import torch

    from qpbench.reference import osqp_batched

    cfg, tr = cell.config, cell.traffic
    if cfg["form"] == "box":
        P, q, A, l, u = (f[k] for k in "PqAlu")
    else:
        P, q = f["P"], f["q"]
        A = torch.cat([f["A"], f["C"]], dim=1)
        l = torch.cat([f["b"], torch.full_like(f["d"], -float("inf"))], dim=1)
        u = torch.cat([f["b"], f["d"]], dim=1)
    o = osqp_batched.solve_fleet(
        P, q, A, l, u, precision="tf32", eps_abs=cfg["eps_abs"],
        eps_rel=cfg["eps_rel"],
        max_iterations=tr["settings"].get("max_iterations", 2000))
    if cfg["form"] == "split":
        me = f["A"].shape[1]
        o = dict(x=o["x"], y=o["y"][:, :me], z=o["y"][:, me:],
                 status=o["status"], iterations=o["iterations"])
    return o


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--tightened-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    from qpbench import harness, judge

    cell = harness.load_cell(args.workload)
    cfg = cell.config
    jobs = [(int(s), "program") for s in args.program_seeds.split(",") if s]
    jobs += [(int(s), "control") for s in args.control_seeds.split(",") if s]
    jobs += [(int(s), "tightened") for s in args.tightened_seeds.split(",") if s]
    Problem, settings, solve, names = harness.solver(cell)
    conv_status = torch.tensor(cfg["converged_status"], device="cuda")
    for seed, who in jobs:
        t = time.perf_counter()
        rows, conv = [], 0
        # One fleet at a time: the control's working set is several fleets'.
        for k in range(cell.traffic["fleets"]):
            f = harness.make_fleet(cell, seed, k, "cuda")
            if who == "program":
                out = harness.outputs(solve(Problem(**f), settings), names)
            elif who == "tightened":
                out = harness.outputs(
                    solve(Problem(**tighten(cfg["form"], f)), settings), names)
            else:
                out = control_output(cell, f)
            rows.append(harness.compare_fleet(cell, k, f, out))
            conv += int(torch.isin(out["status"], conv_status).sum())
            del f, out
            torch.cuda.empty_cache()
        row = dict(judge.worst(rows), converged=conv,
                   seconds=time.perf_counter() - t)
        print(json.dumps({"workload": args.workload, "seed": seed, who: row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
