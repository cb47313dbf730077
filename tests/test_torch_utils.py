"""The port's host utilities against the JAX package's: checkpoints (files
cross between the packages), the LP feasibility certificates, the
diagnostic report, the native LDL' bindings, the f64 reference solver and
the profiling helpers. Everything here runs on the host; tensors go in on
the CPU (``device="cpu"``), as a caller without a card passes them."""

import os
import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.core import state as jax_state
from quadraticprogramsolver_tpu.utils import checkpoint as jax_ckpt
from quadraticprogramsolver_tpu.utils import diagnostics as jax_diag
from quadraticprogramsolver_tpu.utils import feasibility as jax_feas
from quadraticprogramsolver_tpu.utils import native as jax_native
from quadraticprogramsolver_tpu.utils import oracle as jax_oracle

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.core.state import SolveInfo, Solution
from quadraticprogramsolver_tpu_torch.utils import (checkpoint, diagnostics,
                                                    feasibility, native,
                                                    oracle, profiling)

PORT_DIR = os.path.dirname(pt.__file__)


def _arrays(seed, B=3, n=12, m=7, dtype=np.float32):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, n, n))
    P = (X @ X.transpose(0, 2, 1) / n + 0.1 * np.eye(n)).astype(dtype)
    A = rng.standard_normal((B, m, n)).astype(dtype)
    l = -rng.random((B, m)).astype(dtype)
    u = rng.random((B, m)).astype(dtype)
    l[:, 0] = -np.inf
    return P, rng.standard_normal((B, n)).astype(dtype), A, l, u


def _solution_arrays(seed, B=3, n=12, m=7, checks=6):
    """A solution's fields (x, z, y, the info) and a residual history."""
    rng = np.random.default_rng(seed)
    hist = {k: rng.random((checks, B)) for k in ("res_prim", "res_dual", "rho")}
    for v in hist.values():
        v[4:, 1] = np.inf  # lane 1 stopped after four checks
    return dict(
        x=rng.standard_normal((B, n)), z=rng.standard_normal((B, m)),
        y=rng.standard_normal((B, m)), status=np.array([3, 2, 1], np.int32),
        iterations=np.array([100, 75, 150], np.int32),
        res_prim=rng.random(B), res_dual=rng.random(B), rho=rng.random(B),
        objective=rng.standard_normal(B)), hist


def _port_solution(a, hist=None):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    h = None if hist is None else {k: torch.from_numpy(v) for k, v in hist.items()}
    info = SolveInfo(status=t["status"], iterations=t["iterations"],
                     res_prim=t["res_prim"], res_dual=t["res_dual"],
                     rho=t["rho"], objective=t["objective"], history=h)
    return Solution(x=t["x"], z=t["z"], y=t["y"], info=info)


def _jax_solution(a, hist=None):
    info = jax_state.SolveInfo(
        status=jnp.asarray(a["status"]), iterations=jnp.asarray(a["iterations"]),
        res_prim=jnp.asarray(a["res_prim"]), res_dual=jnp.asarray(a["res_dual"]),
        rho=jnp.asarray(a["rho"]), objective=jnp.asarray(a["objective"]),
        history=hist)
    return jax_state.Solution(x=jnp.asarray(a["x"]), z=jnp.asarray(a["z"]),
                              y=jnp.asarray(a["y"]), info=info)


# -------------------------------------------------------------- checkpoint

_INFO = ("status", "iterations", "res_prim", "res_dual", "rho", "objective")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_checkpoint_files_cross_packages(tmp_path, dtype):
    """A problem and a solution saved by the port load in the JAX
    package's loaders, and the reverse, bit for bit and in their dtypes."""
    arrs = _arrays(0, dtype=dtype)
    sol_a, _ = _solution_arrays(1)
    port_qp = pt.make_qp(*arrs, device="cpu")
    checkpoint.save_qp(str(tmp_path / "p_qp.npz"), port_qp)
    checkpoint.save_solution(str(tmp_path / "p_sol.npz"), _port_solution(sol_a))
    jq = jax_ckpt.load_qp(str(tmp_path / "p_qp.npz"))
    js = jax_ckpt.load_solution(str(tmp_path / "p_sol.npz"))
    for k, a in zip("PqAlu", arrs):
        got = np.asarray(getattr(jq, k))
        assert got.dtype == a.dtype and np.array_equal(got, a), k
    for k in ("x", "z", "y"):
        assert np.array_equal(np.asarray(getattr(js, k)), sol_a[k]), k
    for k in _INFO:
        assert np.array_equal(np.asarray(getattr(js.info, k)), sol_a[k]), k

    jax_ckpt.save_qp(str(tmp_path / "j_qp.npz"), qps.make_qp(*arrs))
    jax_ckpt.save_solution(str(tmp_path / "j_sol.npz"), _jax_solution(sol_a))
    pq = checkpoint.load_qp(str(tmp_path / "j_qp.npz"), device="cpu")
    ps = checkpoint.load_solution(str(tmp_path / "j_sol.npz"), device="cpu")
    for k, a in zip("PqAlu", arrs):
        got = getattr(pq, k)
        assert got.device.type == "cpu" and np.array_equal(got.numpy(), a), k
        assert got.numpy().dtype == a.dtype, k
    for k in ("x", "z", "y"):
        assert np.array_equal(getattr(ps, k).numpy(), sol_a[k]), k
    for k in _INFO:
        assert np.array_equal(getattr(ps.info, k).numpy(), sol_a[k]), k


def test_checkpoint_loads_onto_the_card_by_default(tmp_path):
    """Without ``device`` a load goes to the CUDA card; with none present it
    raises rather than landing on the CPU."""
    path = str(tmp_path / "qp.npz")
    checkpoint.save_qp(path, pt.make_qp(*_arrays(2), device="cpu"))
    if torch.cuda.is_available():
        assert checkpoint.load_qp(path).P.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            checkpoint.load_qp(path)


# ------------------------------------------------------------- feasibility

def _equality_fleet():
    """EQUALITY_QP n=10 at seeds 0-7: the generator's infeasible instances
    (all-zero rows with l = u != 0) and feasible ones."""
    return [qps.generate_random_qp(qps.ProblemClass.EQUALITY_QP, 10, seed=s).dense()
            for s in range(8)]


def test_primal_feasible_matches_jax():
    answers = []
    for P, q, A, l, u in _equality_fleet():
        j = jax_feas.primal_feasible(A, l, u)
        p = feasibility.primal_feasible(torch.from_numpy(A), torch.from_numpy(l),
                                        torch.from_numpy(u))
        assert p == j
        answers.append(j)
    assert not all(answers) and any(answers)  # both kinds are in the fleet


def test_dual_unbounded_matches_jax():
    """An LP with a descent ray (P = 0, q'dx < 0 along a free direction),
    its bounded twin, and a strictly convex QP."""
    q = np.array([-1.0, 0.5])
    A = np.array([[0.0, 1.0]])
    cases = [(np.zeros((2, 2)), q, A, np.array([-1.0]), np.array([1.0])),
             (np.zeros((2, 2)), q, np.eye(2), -np.ones(2), np.ones(2)),
             (np.eye(2), q, A, np.array([-1.0]), np.array([1.0]))]
    got = [feasibility.dual_unbounded(*(torch.from_numpy(v) for v in c)) for c in cases]
    assert got == [jax_feas.dual_unbounded(*c) for c in cases] == [True, False, False]


def test_verify_status_flags_matches_jax():
    """The same false positives from a fleet with lanes flagged 4 and 5,
    given as tensors to the port and numpy arrays to the JAX package."""
    insts = _equality_fleet()
    arrs = tuple(np.stack([i[k] for i in insts]) for k in range(5))
    status = np.array([4, 4, 4, 4, 3, 4, 5, 4], np.int32)
    j = jax_feas.verify_status_flags(arrs, status)
    p = feasibility.verify_status_flags(tuple(torch.from_numpy(a) for a in arrs),
                                        torch.from_numpy(status))
    assert p == j and j


# ------------------------------------------------------------- diagnostics

@pytest.mark.parametrize("lane", [0, 1])
@pytest.mark.parametrize("history", [True, False])
def test_solve_report_text_matches_jax(lane, history):
    """The same report, character for character, from the same numbers
    (the port's tensors, the JAX package's numpy arrays)."""
    arrs = _arrays(3, dtype=np.float64)
    sol_a, hist = _solution_arrays(4)
    hist = hist if history else None
    lane_arrs = tuple(a[lane] for a in arrs)
    j = jax_diag.solve_report(lane_arrs, _jax_solution(sol_a, hist), lane=lane,
                              check_interval=25)
    p = diagnostics.solve_report(tuple(torch.from_numpy(a) for a in lane_arrs),
                                 _port_solution(sol_a, hist), lane=lane,
                                 check_interval=25)
    assert p == j
    assert ("residual trace" in p) == history
    cm_j = jax_diag.constraint_map(lane_arrs, sol_a["x"][lane])
    cm_p = diagnostics.constraint_map(lane_arrs, torch.from_numpy(sol_a["x"][lane]))
    assert cm_p.keys() == cm_j.keys()
    for k in cm_j:
        assert np.array_equal(np.asarray(cm_p[k]), np.asarray(cm_j[k])), k


def test_save_report_png(tmp_path):
    """A PNG where matplotlib imports, else None (the JAX package's rule)."""
    arrs = _arrays(5, dtype=np.float64)
    sol_a, hist = _solution_arrays(6)
    path = str(tmp_path / "report.png")
    out = diagnostics.save_report_png(tuple(a[0] for a in arrs),
                                      _port_solution(sol_a, hist), path, lane=0)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert out is None
    else:
        assert out == path and os.path.getsize(path) > 0


# ------------------------------------------------------------------ native

def _kkt_arrays(seed, n=30, m=20):
    rng = np.random.default_rng(seed)
    X = sp.random(n, n, density=0.2, random_state=seed)
    P = (X @ X.T + 0.1 * sp.identity(n)).tocsc()
    A = sp.random(m, n, density=0.3, random_state=seed + 1).tocsc()
    return P, A, rng.standard_normal(n + m)


@pytest.mark.parametrize("ordering", ["natural", "mindeg"])
def test_native_ldl_matches_jax(ordering):
    """The port's bindings build the repository's native/qps_native.cpp into
    its own _build/ and factor and solve as the JAX package's do: the same
    minimum-degree permutation, L's nonzeros and pivots, solves within
    1e-12, a refactor on the same pattern."""
    P, A, b = _kkt_arrays(0)
    K = sp.bmat([[P + 1e-6 * sp.identity(30), A.T],
                 [A, -sp.identity(20) / 0.1]], format="csc")
    assert np.array_equal(native.mindeg_ordering(K), jax_native.mindeg_ordering(K))
    fp = native.LDLFactorization(K, ordering=ordering)
    fj = jax_native.LDLFactorization(K, ordering=ordering)
    assert (fp.nnz_L, fp.num_positive_pivots) == (fj.nnz_L, fj.num_positive_pivots)
    assert np.abs(fp.D - fj.D).max() <= 1e-12 * np.abs(fj.D).max()
    B2 = np.stack([b, 2 * b], axis=1)
    for rhs in (b, B2):
        xp, xj = fp.solve(rhs), fj.solve(rhs)
        assert np.abs(xp - xj).max() <= 1e-12 * max(np.abs(xj).max(), 1.0)
    K2 = K.copy()
    K2.data = K2.data * 1.5
    xp, xj = fp.refactor(K2).solve(b), fj.refactor(K2).solve(b)
    assert np.abs(xp - xj).max() <= 1e-12 * max(np.abs(xj).max(), 1.0)
    kp = native.kkt_factorization(P, A, 0.1, 1e-6)
    kj = jax_native.kkt_factorization(P, A, 0.1, 1e-6)
    assert np.abs(kp.solve(b) - kj.solve(b)).max() <= 1e-12 * max(
        np.abs(kj.solve(b)).max(), 1.0)
    lib = os.path.realpath(native._LIB)
    assert lib.startswith(os.path.realpath(os.path.join(PORT_DIR, "_build")) + os.sep)
    assert os.path.isfile(lib)


def test_native_build_rebuilds_and_raises(tmp_path, monkeypatch):
    """The library is rebuilt when its source is newer, and a build that
    fails raises with g++'s message (a copy of the source in a temporary
    directory, so the package's own build is not touched)."""
    src = tmp_path / "qps_native.cpp"
    shutil.copy(native._SRC, src)
    lib = tmp_path / "_build" / "libqps_native.so"
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_LIB", str(lib))
    monkeypatch.setattr(native, "_lib", None)
    native._load()
    built = os.path.getmtime(lib)
    monkeypatch.setattr(native, "_lib", None)
    native._load()
    assert os.path.getmtime(lib) == built  # up to date: no rebuild
    later = time.time() + 10
    os.utime(src, (later, later))
    monkeypatch.setattr(native, "_lib", None)
    native._load()
    assert os.path.getmtime(lib) > built
    src.write_text("this is not C++\n")
    os.utime(src, (later + 10, later + 10))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native._load()


# ------------------------------------------------------------------ oracle

@pytest.mark.parametrize("linsys", ["ldl", "splu"])
def test_solve_qp_reference_matches_jax(linsys):
    """The f64 reference solver: identical status and iterations to the
    JAX package's, x within 1e-10, for both linear-system routes (tensor
    input accepted by the port's)."""
    P, q, A, l, u = (a[0] for a in _arrays(7, dtype=np.float64))
    kw = dict(eps_abs=1e-9, eps_rel=1e-9, rho=0.1, linsys=linsys)
    j = jax_oracle.solve_qp_reference(P, q, A, l, u, **kw)
    p = oracle.solve_qp_reference(*(torch.from_numpy(v) for v in (P, q, A, l, u)), **kw)
    assert (p.status, p.iterations) == (j.status, j.iterations) and j.status == 3
    assert np.abs(p.x - j.x).max() <= 1e-10
    assert np.abs(p.y - j.y).max() <= 1e-10
    assert p.rho == j.rho
    with pytest.raises(ValueError, match="linsys"):
        oracle.solve_qp_reference(P, q, A, l, u, linsys="lu")


# --------------------------------------------------------------- profiling

def test_profiling_trace_timer_and_sync(tmp_path):
    """trace() writes one Chrome trace file of the block on the CPU, which
    holds the solve's ``qps.solve`` span as a host event that times the
    solve; hard_sync walks a Solution (nothing to wait for here)."""
    import json

    log_dir = tmp_path / "trace"
    qp = pt.make_qp(*_arrays(8), device="cpu")
    with profiling.trace(str(log_dir)):
        sol = pt.solve(qp, pt.Settings(max_iterations=50))
        profiling.hard_sync(sol)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    (solve,) = [e for e in events if e.get("name") == "qps.solve"]
    assert solve["ph"] == "X" and solve["cat"] == "cpu_op" and solve["dur"] > 0
    assert {"qps.factor", "qps.chunk", "qps.check", "qps.sync"} <= {
        e.get("name") for e in events}
