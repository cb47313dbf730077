"""CPU tests of the benchmark: ``python -m pytest qpbench/tests`` from the
root of the repository. Every cell runs here at a small size on the CPU,
where the port's kernel wrappers run their plain PyTorch versions."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

#: Each cell's traffic at a size the CPU runs in about a second: the same
#: families, settings and limits, two fleets of a few lanes and smaller n (the padded cell
#: still pads: 120/60 -> 128/128).
SMALL = {
    "admm_rqp.n512.b4096.fused": dict(batch=4, shape={"n": 128, "m": 128}),
    "prox.n512.b4096.fused": dict(batch=4, shape={"n": 128, "me": 64, "mi": 64}),
    "admm_rqp.n500.b4096.padded": dict(batch=4, shape={"n": 120, "m": 60}),
    "admm_rqp.n512.b2048.defaults": dict(batch=4, shape={"n": 128, "m": 64}),
}
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def small(cell: str) -> dict:
    """The overrides of ``cell``'s traffic for a CPU run."""
    return dict(SMALL[cell], fleets=2)


@pytest.fixture
def no_card():
    """Runs here decide on the CPU; a machine with a card skips the tests
    that need its absence."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    torch.set_num_threads(2)
    return "cpu"
