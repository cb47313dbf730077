"""The port's row-split sparse QP (parallel/sparse_mesh.py) against the JAX
package's, case for case with tests/test_sparse_mesh.py.

One world of 4 gloo ranks on the CPU runs every case once (the module
fixture, tests/test_torch_parallel_dense.py: ``run_world``) while the JAX
mesh solves run here on 4 of the conftest's virtual devices. Every rank
must return the same whole solution, bit for bit. f64: statuses and
iterations identical to the JAX mesh solve, x, y and z within 1e-8 of it;
the port's mesh is also held to the port's single-card SparseQP solve at the
JAX test's bars (x and z within 1e-7, the objective 1e-8 relative).

The instances are tests/test_sparse_mesh.py's generator at n = 64, m = 32,
density 0.05 and P's shift 5 (its own: n = 600, 0.01, 0.05), at the JAX
test's settings (cg_eps 1e-12): about 650 CG steps a solve, each one product
all-reduce and one flag all-reduce over gloo. The JAX test's instances take
about 15,000 CG steps, a minute of collectives a solve on a CPU world.
"""

import dataclasses

import jax
import numpy as np
import pytest
import scipy.sparse as sp
from jax.sharding import Mesh

import quadraticprogramsolver_tpu as qps
from quadraticprogramsolver_tpu.models.scaling import (
    equilibrate_sparse_host as j_equilibrate)
from quadraticprogramsolver_tpu.parallel import sparse_mesh as jsm
from quadraticprogramsolver_tpu.utils.oracle import kkt_optimality

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.models.scaling import (
    equilibrate_sparse_host as p_equilibrate)
from quadraticprogramsolver_tpu_torch.parallel import sparse_mesh as psm
from quadraticprogramsolver_tpu_torch.parallel.launch import Call
from quadraticprogramsolver_tpu_torch.utils.interop import settings_from_dict
from test_torch_parallel_dense import (WORLD, _close, _ok, _same_run,
                                       run_world)

ROWS = ((WORLD,), ("rows",))
SETTINGS = qps.Settings(max_iterations=2000, eps_abs=1e-9, eps_rel=1e-9,
                        rho=0.1, adaptive_rho=True, check_interval=25,
                        cg_eps=1e-12, cg_max_iterations=400)


def _sparse_problem(n=64, m=32, seed=0, density=0.05, shift=5.0):
    rng = np.random.default_rng(seed)
    G = sp.random(n, n, density=density, random_state=rng,
                  data_rvs=rng.standard_normal, format="csr")
    Pm = (G.T @ G + shift * sp.identity(n)).tocsr()
    A = sp.random(m, n, density=density, random_state=rng,
                  data_rvs=rng.standard_normal, format="csr")
    # No structurally empty constraint rows.
    A = A + sp.diags(np.ones(min(m, n)), 0, shape=(m, n), format="csr")
    q = rng.standard_normal(n)
    u = rng.random(m) + 0.5
    l = -(rng.random(m) + 0.5)
    return Pm, q, A, l, u


def _pst(st):
    return settings_from_dict(dataclasses.asdict(st))


def _case(problem, st, jscal=None, pscal=None, extra=(), single=True):
    """The port's mesh solve (and ``extra`` world calls), its single-card
    solve, and the inputs of the JAX mesh solve."""
    Pm, q, A, l, u = problem
    m = A.shape[0]
    sq = psm.shard_sparse_qp(Pm, q, A, l, u, WORLD, dtype=np.float64,
                             scaling=pscal, device="cpu")
    world = [Call(psm.solve_sparse_mesh, (sq, _pst(st)),
                  {"m_orig": m, "scaling": pscal}, mesh=ROWS)]
    world += [dataclasses.replace(c, args=(sq,) + c.args) for c in extra]
    singles = []
    if single:
        sqp = pt.make_sparse_qp(Pm, q, A, l, u, dtype=np.float64,
                                device="cpu")
        singles = [Call(pt.solve, (sqp, _pst(st)), {"scaling": pscal})]
    return world, singles, {"problem": problem, "st": st, "scaling": jscal}


def _scaled(seed):
    """tests/test_sparse_mesh.py's badly scaled rows, equilibrated by each
    package's host Ruiz (the same scaled matrices)."""
    Pm, q, A, l, u = _sparse_problem(seed=seed)
    s = np.logspace(-2, 2, A.shape[0])
    A = sp.diags(s) @ A
    l, u = s * l, s * u
    *scaled_j, jscal = j_equilibrate(Pm, q, A, l, u)
    *scaled_p, pscal = p_equilibrate(Pm, q, A, l, u, device="cpu")
    return (Pm, q, A, l, u), tuple(scaled_j), jscal, tuple(scaled_p), pscal


def _cases():
    c = {}
    c["match"] = _case(_sparse_problem(), SETTINGS)
    orig, sj, jscal, sp_, pscal = _scaled(3)
    world, singles, inp = _case(sp_, SETTINGS, jscal, pscal)
    inp.update(problem=sj, original=orig)
    c["ruiz"] = (world, singles, inp)
    c["uneven"] = _case(_sparse_problem(m=31, seed=1), SETTINGS)
    n = 64
    rows = sp.csr_matrix(np.vstack([np.eye(n)[:1], np.eye(n)[:1]]))
    c["infeasible"] = _case(
        (sp.identity(n, format="csr"), np.zeros(n), rows,
         np.array([1.0, -np.inf]), np.array([np.inf, -1.0])),
        dataclasses.replace(SETTINGS, max_iterations=4000, eps_abs=1e-8,
                            eps_rel=1e-8), single=False)
    c["anderson"] = _case(_sparse_problem(seed=5),
                          dataclasses.replace(SETTINGS, anderson_memory=8))
    polish = dataclasses.replace(SETTINGS, eps_abs=1e-6, eps_rel=1e-6,
                                 polish_iterations=5)
    world, singles, inp = _case(_sparse_problem(seed=7), polish)
    # The unpolished reference: the port's single-card solve at eps 1e-6.
    sqp = singles[0].args[0]
    singles.append(Call(pt.solve, (sqp, _pst(dataclasses.replace(
        polish, polish_iterations=0)))))
    c["polish"] = (world, singles, inp)
    Pm, q, A, l, u = _sparse_problem(seed=9)
    # A block of rows made equalities, so the weights differ.
    l = l.copy()
    l[:10] = u[:10] = 0.3 * np.sign(u[:10])
    c["vector_rho"] = _case((Pm, q, A, l, u),
                            dataclasses.replace(SETTINGS, rho_eq_scale=10.0))
    seg = dataclasses.replace(SETTINGS, anderson_memory=8)
    c["segmented"] = _case(
        _sparse_problem(seed=11), seg, single=False,
        extra=[Call(psm.solve_sparse_mesh_segmented, (_pst(seg),),
                    {"m_orig": 32, "segment_iterations": 25}, mesh=ROWS)])
    return c


def _jax_ref(name, inp):
    """The JAX package's mesh solve of the case on 4 devices."""
    Pm, q, A, l, u = inp["problem"]
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("rows",))
    sq = jsm.shard_sparse_qp(Pm, q, A, l, u, WORLD, dtype=np.float64,
                             scaling=inp["scaling"])
    return jsm.solve_sparse_mesh(sq, inp["st"], mesh, m_orig=A.shape[0],
                                 scaling=inp["scaling"])


@pytest.fixture(scope="module")
def world():
    return run_world(_cases(), _jax_ref)


def _outcome(sol):
    status = int(sol.info.status)
    return qps.Status.SOLVED if status == qps.Status.SOLVED_ADMM else status


def _mesh_case(world, name, x_tol=1e-7):
    """The port's mesh against the JAX mesh (the same run, 1e-8) and the
    port's single-card solve (status and iterations, x and z within the JAX
    test's 1e-7)."""
    case = world[name]
    sol = _ok(case.res)
    _same_run(sol, case.ref)
    np.testing.assert_allclose(float(sol.info.objective),
                               float(case.ref.info.objective), rtol=1e-8)
    if case.single:
        plain = _ok(case.single)
        # SOLVED_ADMM (2) and SOLVED (3) are one outcome against the
        # single-card solve: the mesh's fixed-point test spans the whole
        # check interval (x - x_start, as the JAX mesh's
        # parallel/sparse_mesh.py:501) where the single-card one spans the
        # last iteration, so at a check where both tests pass the two
        # solves can name different ones (the JAX mesh and the port's are
        # held to the same code above).
        assert _outcome(sol) == _outcome(plain)
        assert int(sol.info.iterations) == int(plain.info.iterations)
        for leaf in ("x", "z"):
            np.testing.assert_allclose(getattr(sol, leaf),
                                       getattr(plain, leaf), rtol=0,
                                       atol=x_tol)
    return sol, case


def _kkt(problem, sol):
    Pm, q, A, l, u = problem
    return kkt_optimality(Pm.toarray(), q, A.toarray(), l, u, sol.x, sol.z,
                          sol.y)


def test_mesh_matches_single_device(world):
    sol, case = _mesh_case(world, "match")
    plain = _ok(case.single)
    np.testing.assert_allclose(float(sol.info.objective),
                               float(plain.info.objective), rtol=1e-8)
    rep = _kkt(case.inp["problem"], sol)
    assert rep.optimal(1e-6), rep


def test_mesh_with_host_ruiz_scaling(world):
    sol, case = _mesh_case(world, "ruiz")
    rep = _kkt(case.inp["original"], sol)
    assert rep.optimal(1e-6), rep


def test_mesh_uneven_rows(world):
    # m = 31 rows on 4 shards: inert-row padding must not change the
    # solution, and the duals come back at the caller's row count.
    sol, _ = _mesh_case(world, "uneven")
    assert sol.z.shape == (31,) and sol.y.shape == (31,)


def test_mesh_infeasible_flagged(world):
    sol, case = _mesh_case(world, "infeasible")
    assert int(sol.info.status) == qps.Status.PRIMAL_INFEASIBLE


def test_mesh_anderson_matches_single_device(world):
    _mesh_case(world, "anderson")


def test_mesh_polish_matches_single_device(world):
    sol, case = _mesh_case(world, "polish")
    unpolished = _ok(case.single, 1)
    rep_polished = _kkt(case.inp["problem"], sol)
    rep_plain = _kkt(case.inp["problem"], unpolished)
    assert rep_polished.res_dual <= rep_plain.res_dual
    assert rep_polished.optimal(1e-8), rep_polished


def test_mesh_vector_rho_matches_single_device(world):
    sol, _ = _mesh_case(world, "vector_rho")
    assert int(sol.info.status) in (2, 3)


def test_mesh_segmented_matches_monolithic(world):
    mono, case = _mesh_case(world, "segmented")
    seg = _ok(case.res, 1)
    # Segments of one check: more than one ran, so the carry was used.
    assert int(mono.info.iterations) > 25
    assert int(seg.info.status) == int(mono.info.status)
    assert int(seg.info.iterations) == int(mono.info.iterations)
    _close(seg, mono, 1e-9, ("x", "z"))
