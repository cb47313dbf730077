"""Run one cell of BENCHMARK.json once on the card and print one JSON line.

    python3 qpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Exits with a code other than 0, printing
no result, when there is no CUDA card (or fewer than the cell asks for),
when the port cannot be imported, or when jax, jaxlib, flax or the JAX
package was loaded in this process. The port builds its kernels into its
own ``_build/`` inside the checkout, so only the first run there compiles.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import quadraticprogramsolver_tpu_torch  # noqa: F401  (the system under test)
    import torch

    from qpbench import harness

    cell = harness.load_cell(args.workload)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"qpbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {n}", file=sys.stderr)
        return 2
    line, err = harness.run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), t_start=T_START)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"qpbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for e in err:
        print(e, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
