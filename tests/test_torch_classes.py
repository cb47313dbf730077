"""The port's generator, fleet stacking, top-level names and whole solves of
the 9 problem classes and the golden fixtures, against the JAX package.

f64 on the CPU. The 9-class generator is a copy of the JAX package's numpy
code, so from one seed its arrays are identical. The classes run at every
FEASIBLE_SEEDS instance of tests/test_admm.py with its SMALL_M, one fleet a
class (``stack_qps(pad=True)``, so JAX compiles once a class), with and
without Ruiz scaling (``scaling_iters``): identical statuses and iteration
counts, x and y within 1e-7. The golden fixtures are reproduced at
tests/test_golden.py's settings within its 1e-5.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.problems import generator as jgen

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.utils.interop import settings_from_dict

# tests/test_admm.py's instances (that module is a test file of the JAX
# package, so its constants are restated here rather than imported).
SMALL_M = {"lasso": 30, "huber": 30, "svm": 30, "inequality_qp": 30}
FEASIBLE_SEEDS = {
    "random_qp": (0, 3, 4), "inequality_qp": (0, 1, 2),
    "equality_qp": (6, 7), "optimal_control": (0, 3, 4),
    "portfolio": (0, 1, 2), "lasso": (0, 1, 2), "huber": (0, 1, 2),
    "svm": (0, 1, 2), "isotonic": (0, 1, 2),
}
CLASS_SETTINGS = dict(max_iterations=50_000, eps_abs=1e-7, eps_rel=1e-7,
                      rho=0.1, adaptive_rho=True)
GOLDEN = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden",
                                       "*.npz")))


def _np(qp):
    return tuple(np.asarray(v) for v in (qp.P, qp.q, qp.A, qp.l, qp.u))


def test_class_names_match():
    assert [c.value for c in pt.ALL_CLASSES] == [c.value for c in qps.ALL_CLASSES]
    assert [c.name for c in pt.ProblemClass] == [c.name for c in qps.ProblemClass]


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("cls", [c.value for c in qps.ALL_CLASSES])
def test_generate_random_qp_identical(cls, seed):
    m = SMALL_M.get(cls, 0)
    a = jgen.generate_random_qp(qps.ProblemClass(cls), 12, m, seed=seed)
    b = pt.generate_random_qp(pt.ProblemClass(cls), 12, m, seed=seed)
    assert (a.n, a.m) == (b.n, b.m)
    for u, v in zip(a.dense(), b.dense()):
        assert u.dtype == v.dtype and np.array_equal(u, v)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_generate_batch_identical(dtype):
    a = qps.generate_batch(qps.ProblemClass.PORTFOLIO, 3, 20, seed=2,
                           dtype=dtype)
    b = pt.generate_batch(pt.ProblemClass.PORTFOLIO, 3, 20, seed=2,
                          dtype=dtype, device="cpu")
    assert b.device.type == "cpu" and b.batch_shape == (3,)
    for u, v in zip(_np(a), b.tensors()):
        assert v.numpy().dtype == dtype and np.array_equal(u, v.numpy())


def test_generate_batch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.generate_batch(pt.ProblemClass.RANDOM_QP, 2, 10)


@pytest.mark.parametrize("pad", [False, True])
def test_stack_qps_identical(pad):
    sizes = (10, 14, 12) if pad else (10, 10, 10)
    datas = [jgen.generate_random_qp(qps.ProblemClass.RANDOM_QP, n, seed=i)
             for i, n in enumerate(sizes)]
    a = qps.stack_qps([qps.make_qp(*d.dense()) for d in datas], pad=pad)
    b = pt.stack_qps([pt.make_qp(*d.dense(), device="cpu") for d in datas],
                     pad=pad)
    for u, v in zip(_np(a), b.tensors()):
        assert u.shape == tuple(v.shape) and np.array_equal(u, v.numpy())


def test_top_level_names():
    """Every public name of the JAX package is a public name of the port."""
    missing = set(qps.__all__) - set(pt.__all__)
    assert not missing, missing
    for name in pt.__all__:
        assert hasattr(pt, name), name
    assert pt.__version__ == qps.__version__ == "0.1.0"


def _class_fleet(cls):
    datas = [jgen.generate_random_qp(qps.ProblemClass(cls), 10,
                                     SMALL_M.get(cls, 0), seed=s)
             for s in FEASIBLE_SEEDS[cls]]
    qp_j = qps.stack_qps([qps.make_qp(*d.dense()) for d in datas], pad=True)
    qp = pt.stack_qps([pt.make_qp(*d.dense(), device="cpu") for d in datas],
                      pad=True)
    return datas, qp_j, qp


@pytest.mark.parametrize("scaling_iters", [0, 10], ids=["plain", "ruiz10"])
@pytest.mark.parametrize("cls", [c.value for c in qps.ALL_CLASSES])
def test_class_fleet_matches_jax(cls, scaling_iters):
    datas, qp_j, qp = _class_fleet(cls)
    st = qps.Settings(scaling_iters=scaling_iters, **CLASS_SETTINGS)
    ref = qps.solve_jit(qp_j, st)
    sol = pt.solve(qp, settings_from_dict(dataclasses.asdict(st)))
    status = sol.info.status.numpy()
    np.testing.assert_array_equal(status, np.asarray(ref.info.status))
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    assert (status >= 2).all() and (status <= 3).all()
    for name in ("x", "y"):
        dev = np.abs(getattr(sol, name).numpy()
                     - np.asarray(getattr(ref, name))).max()
        assert dev <= 1e-7, (name, dev)
    np.testing.assert_allclose(sol.info.res_prim.numpy(),
                               np.asarray(ref.info.res_prim), rtol=1e-5,
                               atol=1e-12)


def test_fixtures_present():
    assert len(GOLDEN) == 6, GOLDEN


@pytest.mark.parametrize("path", GOLDEN, ids=[os.path.basename(p) for p in GOLDEN])
def test_golden_solution_reproduced(path):
    """tests/test_golden.py's fixture, solved by the port at its settings."""
    d = np.load(path)
    qp = pt.make_qp(d["P"], d["q"], d["A"], d["l"], d["u"],
                    dtype=torch.float64, device="cpu")
    st = pt.Settings(max_iterations=50_000, eps_abs=1e-9, eps_rel=1e-9,
                     rho=0.1, adaptive_rho=True)
    sol = pt.solve(qp, st)
    assert int(sol.info.status) in (pt.Status.SOLVED, pt.Status.SOLVED_ADMM)
    assert np.abs(sol.x.numpy() - d["x"]).max() <= 1e-5
