"""Nothing that qpbench runs imports jax, jaxlib, flax or the JAX package
(top-level names compared whole); traffic/ and reference/ import nothing of
the port either."""

import ast
import subprocess
import sys

from conftest import ROOT, small
from qpbench import harness

PORT = "quadraticprogramsolver_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "qpbench").rglob("*.py"))
    assert len(files) > 20
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & set(harness.FORBIDDEN), (f, tops)


def test_traffic_and_reference_import_nothing_of_the_port():
    for sub in ("traffic", "reference"):
        for f in sorted((ROOT / "qpbench" / sub).glob("*.py")):
            tops = {m.split(".")[0] for m in _imports(f)}
            assert PORT not in tops, (f, tops)


def test_names_are_compared_whole():
    assert harness.forbidden_modules([PORT, PORT + ".ops", "jaxtyping", "qpbench"]) == []
    assert harness.forbidden_modules(["jax.numpy", "quadraticprogramsolver_tpu.core",
                                      "flax"]) == ["flax", "jax.numpy",
                                                   "quadraticprogramsolver_tpu.core"]


def test_a_run_loads_no_forbidden_module(no_card):
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from qpbench import harness
for cell, ov in {dict((c, small(c)) for c in ("admm_rqp.n512.b4096.fused", "prox.n512.b4096.fused"))!r}.items():
    line, _ = harness.run_cell(cell, 5, 0.2, True, t_start=time.perf_counter(),
                               device="cpu", overrides=ov)
    assert line["correct"], line
print(harness.forbidden_modules(sys.modules))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
