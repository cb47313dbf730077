"""Reduced product precision in the port against the JAX package.

``Settings.matmul_precision`` scopes every torch product of an ADMM solve
(``ops/linalg.py: products``), ``factor_precision`` those of the factor off
the slab (M's build and the blocked sweep's products around the FP32 pivot
kernel). On Hopper "default" is the product of the operands rounded to
bf16 once and "high" the bf16x3 sum of their halves, both accumulated in
FP32: the TPU's arithmetic under the same names. JAX's CPU backend ignores
its precision scope, so here the JAX package is the "highest" reference;
in float64 every knob resolves to "highest" in both packages. Fleet:
tests/test_fused_admm.py's ``_fleet`` (RANDOM_QP, 100 padded to 128, B=4).
"""

import ast
import dataclasses
import pathlib
import threading

import numpy as np
import pytest
import torch

import quadraticprogramsolver_tpu as qps
from jax._src.lax import lax as jax_lax

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.core import settings as pt_settings
from quadraticprogramsolver_tpu_torch.models import admm as pt_admm
from quadraticprogramsolver_tpu_torch.models import kkt as pt_kkt
from quadraticprogramsolver_tpu_torch.ops import linalg
from quadraticprogramsolver_tpu_torch.utils.interop import qp_from_numpy

PORT_DIR = pathlib.Path(pt.__file__).parent
B, N = 4, 128
#: tests/test_fused_admm.py:82-87's settings.
BASE = dict(max_iterations=2000, eps_abs=1e-5, eps_rel=1e-5, rho=0.1,
            kkt_refinement_steps=1)
#: Each reduced knob; the factor ones run off the slab (the M^{-1} route:
#: the sweep at n = 128, B = 4).
KNOBS = {"matmul high": dict(matmul_precision="high"),
         "matmul default": dict(matmul_precision="default"),
         "factor high": dict(factor_precision="high"),
         "factor default": dict(factor_precision="default")}


def _fleet(dtype):
    return qps.pad_qp(qps.generate_batch(qps.ProblemClass.RANDOM_QP, batch=B,
                                         num_elements=100, seed=0,
                                         dtype=dtype), N, N)


def _port_qp(dtype):
    qp = _fleet(dtype)
    return qp_from_numpy(*(np.asarray(getattr(qp, k)) for k in "PqAlu"),
                         device="cpu", dtype=getattr(torch, np.dtype(dtype).name))


@pytest.fixture(scope="module")
def jax_solves():
    """JAX's "highest" solves of the fleet in float64 and float32, shared."""
    st = qps.Settings(**BASE)
    return {dt: qps.solve_jit(_fleet(dt), st) for dt in (np.float64, np.float32)}


@pytest.fixture(scope="module")
def port_f64_highest():
    return pt.solve(_port_qp(np.float64), pt.Settings(**BASE))


def _dev(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


# ------------------------------------------------------------------ solves

@pytest.mark.parametrize("knob", list(KNOBS))
def test_f64_solve_matches_jax_and_highest(knob, jax_solves, port_f64_highest):
    """In float64 each reduced knob resolves to "highest": identical
    statuses and iterations to JAX's f64 solve, x and y within 1e-8, and
    bit for bit the port's own f64 "highest" solve."""
    sol = pt.solve(_port_qp(np.float64), pt.Settings(**BASE, **KNOBS[knob]))
    ref = jax_solves[np.float64]
    np.testing.assert_array_equal(sol.info.status.numpy(), np.asarray(ref.info.status))
    np.testing.assert_array_equal(sol.info.iterations.numpy(),
                                  np.asarray(ref.info.iterations))
    assert _dev(sol.x, ref.x) <= 1e-8 and _dev(sol.y, ref.y) <= 1e-8
    for name in ("x", "y", "z"):
        assert torch.equal(getattr(sol, name), getattr(port_f64_highest, name)), name


#: (factor_precision, refinement steps, iteration budget, x bound).
FACTOR_CASES = {
    "high refine 1": ("high", 1, 2000, 1e-5),
    "default refine 2": ("default", 2, 2000, 1e-5),
    "default refine 1": ("default", 1, 4000, 2e-5),
}


@pytest.mark.parametrize("case", list(FACTOR_CASES))
def test_f32_factor_precision_against_jax_highest(case, jax_solves):
    """tests/test_fused_admm.py:79-93 on the port: every lane ends with
    status >= 2 and x near JAX's f32 "highest" solve. The reduced factor
    is real here (M built from bf16 operands), where JAX's CPU run ignores
    it: with one refinement step its M^{-1} leaves a dual-residual floor
    of ~5e-5, so at the test's 2000 iterations one lane of four ends at
    MAX_ITERATIONS (it reaches the fixed-point test at 2475) and x sits
    1.6e-5 from the reference; that case gets 4000 iterations and 2e-5.
    Two refinement steps, or the bf16x3 factor, meet the test's 1e-5 at
    its own budget (measured 2.6e-6 and 1.2e-6)."""
    prec, refine, iters, bound = FACTOR_CASES[case]
    st = pt.Settings(**{**BASE, "max_iterations": iters,
                        "kkt_refinement_steps": refine},
                     factor_precision=prec)
    sol = pt.solve(_port_qp(np.float32), st)
    assert (sol.info.status.numpy() >= 2).all(), sol.info.status
    assert _dev(sol.x, jax_solves[np.float32].x) <= bound


#: (matmul_precision, eps, x bound against JAX's f32 "highest" solve at
#: the test's 1e-5).
MATMUL_CASES = {"high": (1e-4, 1e-4), "default": (3e-2, 5e-2)}


@pytest.mark.parametrize("prec", list(MATMUL_CASES))
def test_f32_matmul_precision_against_jax_highest(prec, jax_solves):
    """Every product of the solve at "high" or "default" (the check's too,
    as JAX's scope reaches them). No reference test pins a tolerance, so
    these are this fleet's measurements: "high" (bf16x3, the lo*lo term
    dropped) floors the residuals near 1e-5 relative, and at eps 1e-5
    every lane runs to MAX_ITERATIONS; at eps 1e-4 they converge with x
    5.5e-5 from the reference (bound 1e-4). "default" (one bf16 pass)
    floors them near 1e-2, the stall the JAX package documents
    (models/admm.py:664-668): at eps 1e-5 to 1e-2 every lane ends at
    MAX_ITERATIONS with x 1.5e-2 off; at eps 3e-2 all converge, x 2.4e-2
    off (bound 5e-2). The stall at 1e-5 is asserted too: a route that
    quietly ran FP32 products would converge there."""
    eps, bound = MATMUL_CASES[prec]
    qp = _port_qp(np.float32)
    sol = pt.solve(qp, pt.Settings(**{**BASE, "eps_abs": eps, "eps_rel": eps},
                                   matmul_precision=prec))
    assert (sol.info.status.numpy() >= 2).all(), sol.info.status
    assert _dev(sol.x, jax_solves[np.float32].x) <= bound
    stalled = pt.solve(qp, pt.Settings(**BASE, matmul_precision=prec))
    assert (stalled.info.status.numpy() == 1).all(), stalled.info.status


# ----------------------------------------------------------------- helpers

def _operands(seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(3, 40, 70, generator=g, dtype=dtype),
            torch.randn(3, 70, 20, generator=g, dtype=dtype))


def _f64_from_bf16(a, b, prec):
    """The f64 product of the operands as the precision reads them."""
    if prec == "default":
        return linalg.bf16_round(a).double() @ linalg.bf16_round(b).double()
    ah, al = (h.double() for h in linalg.bf16_split(a))
    bh, bl = (h.double() for h in linalg.bf16_split(b))
    return ah @ bh + ah @ bl + al @ bh


def _rel(a, ref):
    return float((a.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("prec", ["default", "high"])
def test_helpers_against_f64_from_bf16_operands(prec):
    """mm, mv, mv_t and sub_mm_ at "default" and "high" within 1e-6 of the
    max of an f64 recomputation from the same bf16-rounded operands (only
    the FP32 accumulation differs); batch axes broadcast, a shared 2-D
    operand on either side."""
    a, b = _operands(0)
    with linalg.products(prec):
        assert linalg.current_precision() == prec
        assert _rel(linalg.mm(a, b), _f64_from_bf16(a, b, prec)) <= 1e-6
        assert _rel(linalg.mm(a, b[0]), _f64_from_bf16(a, b[0], prec)) <= 1e-6
        assert _rel(linalg.mm(a[0], b), _f64_from_bf16(a[0], b, prec)) <= 1e-6
        v = b[..., 0]
        assert _rel(linalg.mv(a.transpose(1, 2), a[..., 0]),
                    _f64_from_bf16(a.transpose(1, 2), a[..., :1], prec)[..., 0]) <= 1e-6
        assert _rel(linalg.mv_t(b, v[..., :70]),
                    _f64_from_bf16(v[..., None, :70], b, prec)[..., 0, :]) <= 1e-6
        W = torch.ones(3, 40, 20)
        linalg.sub_mm_(W, a, b)
        assert _rel(W, 1.0 - _f64_from_bf16(a, b, prec)) <= 1e-6
    # Reduced for real: apart from the FP32 product by far more than 1e-6.
    with linalg.products(prec):
        assert _rel(linalg.mm(a, b), (a.double() @ b.double())) > 1e-6


def test_helpers_full_precision_where_they_must_be():
    """At "highest", and for float64 operands at any precision, the helpers
    are torch's own products, bit for bit (sub_mm_ one baddbmm_)."""
    a, b = _operands(1)
    a64, b64 = a.double(), b.double()
    assert torch.equal(linalg.mm(a, b), torch.matmul(a, b))
    for prec in ("default", "high"):
        with linalg.products(prec):
            assert torch.equal(linalg.mm(a64, b64), torch.matmul(a64, b64))
            assert torch.equal(linalg.mv(a64, b64[..., 0][..., :70]),
                               torch.matmul(a64, b64[..., :70, :1].reshape(3, 70, 1))[..., 0])
        W, W2 = torch.zeros(3, 40, 20), torch.zeros(3, 40, 20)
        linalg.sub_mm_(W, a, b)
        assert torch.equal(W, W2.baddbmm_(a, b, alpha=-1.0))


def test_scope_nesting_inheritance_and_threads():
    """products(None) keeps the enclosing precision, an inner scope's exit
    brings the outer one back (also on a raise), the precision is the
    thread's own, and torch's own float32 precision is "highest" (TF32
    off) inside any scope."""
    assert linalg.current_precision() == "highest"
    with linalg.products("bfloat16"):
        assert linalg.current_precision() == "default"
        assert torch.get_float32_matmul_precision() == "highest"
        with linalg.products():
            assert linalg.current_precision() == "default"
        with pytest.raises(RuntimeError):
            with linalg.products("tensorfloat32"):
                assert linalg.current_precision() == "high"
                raise RuntimeError
        assert linalg.current_precision() == "default"
        seen = []
        t = threading.Thread(target=lambda: seen.append(linalg.current_precision()))
        t.start()
        t.join(10)
        assert seen == ["highest"]
    assert linalg.current_precision() == "highest"
    with pytest.raises(ValueError, match="precision"):
        with linalg.products("bf16"):
            pass


# ------------------------------------------------------------------- names

def test_precision_names_match_jax():
    """Every name JAX's precision strings take maps onto the same level;
    the Settings validators take them and raise ValueError on any other
    (the JAX package raises only when a solve opens its scope: a deliberate
    difference)."""
    levels = {jax_lax.Precision.HIGHEST: "highest", jax_lax.Precision.HIGH: "high",
              jax_lax.Precision.DEFAULT: "default"}
    jax_names = {k: levels[v] for k, v in jax_lax._precision_strings.items()
                 if k is not None}
    assert pt_settings.PRECISION_NAMES == jax_names
    for name in jax_names:
        assert pt.Settings(matmul_precision=name).matmul_precision == name
        assert pt.Settings(factor_precision=name).factor_precision == name
    for field in ("matmul_precision", "factor_precision"):
        with pytest.raises(ValueError, match=field):
            pt.Settings(**{field: "BF16_BF16_F32"})


def test_jax_names_give_the_same_bits():
    """matmul_precision "bfloat16" is "default" and "bfloat16_3x" is "high",
    bit for bit; a chunk_dot_precision outside "highest"/"high"/"default"
    runs as "highest" (the JAX package's chunk kernels compare against
    those two strings), here and in the plan."""
    qp = _port_qp(np.float32)
    st = dict(BASE, max_iterations=50)
    for alias, level in (("bfloat16", "default"), ("bfloat16_3x", "high")):
        a = pt.solve(qp, pt.Settings(**st, matmul_precision=alias))
        b = pt.solve(qp, pt.Settings(**st, matmul_precision=level))
        assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y), alias
    fused = dict(st, kkt_refinement_steps=0, sigma_free_rhs=True,
                 fused_factor=True, fused_chunk=True)
    ref = pt.solve(qp, pt.Settings(**fused))
    for name in ("bf16", "float32", "tensorfloat32"):
        st_n = pt.Settings(**fused, chunk_dot_precision=name)
        assert pt.plan(qp, st_n).dot_precision == "highest"
        sol = pt.solve(qp, st_n)
        assert torch.equal(sol.x, ref.x) and torch.equal(sol.y, ref.y), name


# ------------------------------------------------------------ prepared factor

@pytest.mark.parametrize("sigma_free", [False, True])
def test_prepare_caches_the_reduced_factor(sigma_free):
    """prepare with factor_precision caches what the solve's factor builds
    (tests/test_reuse.py:40-55): M^{-1} bit for bit backend.init's under the
    solve's scope, CachedQPSolver's too; on the sigma-free path M^{-1} and G at the factor's
    precision, G = M^{-1}A' from that M^{-1}. Reduced for real: apart from
    the "highest" factor."""
    qp = _port_qp(np.float32)
    kw = dict(BASE, factor_precision="default")
    if sigma_free:
        kw.update(sigma_free_rhs=True, kkt_refinement_steps=0)
    st = pt.Settings(**kw)
    prep = pt_admm.prepare(qp, st)
    rho = torch.full((B,), st.rho)
    sigma = st.sigma_for(qp.dtype)
    with linalg.products(st.matmul_precision):
        if sigma_free:
            rho_row = rho[:, None].expand(B, N)
            with linalg.products(st.factor_precision):
                M_inv = linalg.spd_inverse(pt_kkt._build_normal_matrix(qp, rho_row, sigma))
                G = linalg.mm(M_inv, qp.A.transpose(-1, -2))
            assert torch.equal(prep.M_inv, M_inv) and torch.equal(prep.cache["G"], G)
            hi = pt_admm.prepare(qp, dataclasses.replace(st, factor_precision=None))
            assert float((prep.M_inv - hi.M_inv).abs().max()) > 1e-6
        else:
            init = pt_kkt.get_backend(st.kkt_backend, qp).init(qp, rho, sigma, st)
            assert torch.equal(prep.cache["M_inv"], init["M_inv"])
            cached = pt.CachedQPSolver(qp, st).prepared.cache["M_inv"]
            assert torch.equal(cached, init["M_inv"])
            hi = pt_admm.prepare(qp, dataclasses.replace(st, factor_precision=None))
            assert float((prep.cache["M_inv"] - hi.cache["M_inv"]).abs().max()) > 1e-6


# ------------------------------------------------------------ static check

#: Products of models/ and core/ that stay FP32 on purpose, by (file,
#: enclosing function or class): the prox family pins "highest" as the JAX
#: package's does (models/proxqp.py:258, 295); the sparse CSR products and
#: the host-side scipy scaling are not MXU dots in JAX either (its ELL and
#: BCOO products are gathers and elementwise products).
FP32_SITES = {
    ("models/proxqp.py", "_gram"), ("models/proxqp.py", "prepare"),
    ("core/problem.py", "ProxQPProblem"),
    ("core/sparse_problem.py", "_product"), ("core/sparse_problem.py", "SparseQP"),
    ("models/scaling.py", "equilibrate_sparse_host"),
}
_PRODUCTS = {"matmul", "einsum", "bmm", "mm", "mv", "baddbmm", "addmm", "matrix_power"}


def _product_sites(path):
    """(enclosing names, line) of every torch product call and ``@``."""
    tree = ast.parse(path.read_text())
    out = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            inner = scope
            if isinstance(child, (ast.FunctionDef, ast.ClassDef)):
                inner = scope + (child.name,)
            is_call = (isinstance(child, ast.Call)
                       and isinstance(child.func, ast.Attribute)
                       and child.func.attr in _PRODUCTS
                       and isinstance(child.func.value, ast.Name)
                       and child.func.value.id == "torch")
            is_at = isinstance(child, ast.BinOp) and isinstance(child.op, ast.MatMult)
            if is_call or is_at:
                out.append((scope, child.lineno))
            visit(child, inner)

    visit(tree, ())
    return out


def test_no_admm_product_bypasses_the_helpers():
    """Static check: no torch.matmul/einsum/bmm or ``@`` product in the
    ADMM family's models/ and core/ code outside the scoped helpers
    (ops/linalg.py: mm, mv, mv_t), but the FP32 sites listed above."""
    found = set()
    for sub in ("models", "core"):
        for f in sorted((PORT_DIR / sub).glob("*.py")):
            rel = f"{sub}/{f.name}"
            for scope, line in _product_sites(f):
                allowed = any((rel, name) in FP32_SITES for name in scope)
                assert allowed, f"{rel}:{line} ({'.'.join(scope)}) bypasses the helpers"
                found.add(next((rel, n) for n in scope if (rel, n) in FP32_SITES))
    assert found == FP32_SITES, FP32_SITES - found
