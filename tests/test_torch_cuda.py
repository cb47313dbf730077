"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card (sm_90a) and nvcc; elsewhere they skip. On a
machine with a card but without jax, run them without the repo's conftest
(which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.ops import (
    fused_admm, fused_factor, fused_proxqp, linalg, spd_kernels)
from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
    device_random_qp_fleet)
from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
    device_prox_fleet)

pytestmark = pytest.mark.cuda
B, N, M = 8, 256, 128
TOL = 1e-5  # relative to max(|plain|, 1): FP32 with another sum order


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b):
    scale = max(float(b.abs().max()), 1.0)
    return float((a - b).abs().max()) / scale <= TOL


def _fleet(dev, seed=0, b=B, n=N, m=M):
    g = torch.Generator(device=dev).manual_seed(seed)
    return device_random_qp_fleet(b, n, m, generator=g), g


def test_factor_kernels_match_plain(dev):
    qp, _ = _fleet(dev)
    rho = torch.full((B, M), 0.4, device=dev)
    S = fused_factor.build_slab(qp.P, qp.A, qp.q, rho, 1e-6)
    Sp = fused_factor.build_slab_plain(qp.P, qp.A, qp.q, rho, 1e-6)
    assert _close(S, Sp)
    kp = fused_factor.slab_k(M)
    for j in range(N // 128 - 1, -1, -1):
        w_out = kp + j * 128
        D = Sp[:, j * 128:(j + 1) * 128, w_out:w_out + 128]
        Dinv = spd_kernels.spd_inverse_unrolled(D)          # strided view
        assert _close(Dinv, spd_kernels.pivot_sweep_v3_plain(D))
        assert torch.equal(Dinv, spd_kernels.pivot_sweep_v3_prev(D))
        S1 = Sp.clone()
        fused_factor.slab_level(S1, Dinv, j, w_out)
        fused_factor.slab_level_plain(Sp, Dinv, j, w_out)
        assert _close(S1, Sp)
    Sk = fused_factor.fused_factor_solve(qp.P, qp.A, qp.q, rho, sigma=1e-6)
    assert _close(Sk[..., : M + 1], Sp[..., : M + 1])


def test_chunk_kernel_matches_plain(dev):
    qp, g = _fleet(dev, 1)
    rho = torch.full((B, M), 0.4, device=dev)
    S = fused_factor.fused_factor_solve(qp.P, qp.A, qp.q, rho, sigma=1e-6)
    G, gv = S[..., :M].contiguous(), S[..., M].contiguous()
    x = torch.randn((B, N), generator=g, device=dev)
    z = torch.randn((B, M), generator=g, device=dev)
    y = torch.randn((B, M), generator=g, device=dev)
    active = torch.arange(B, device=dev) % 3 != 1
    args = (G, qp.A, gv, qp.l, qp.u, x, z, y, rho, active)
    fused_admm.fused_admm_chunk.variants.clear()
    out = fused_admm.fused_admm_chunk(*args, K=7, alpha=1.6)
    assert dict(fused_admm.fused_admm_chunk.variants) == {
        "highest,G,lanes1,cluster": 1}
    ref = fused_admm.fused_admm_chunk_plain(*args, K=7, alpha=1.6)
    for o, r in zip(out, ref):
        assert _close(o, r)
    assert torch.equal(out[0][~active], x[~active])
    assert torch.equal(out[4][~active], z[~active])
    stream = fused_admm.fused_admm_chunk_streaming(*args, K=7, alpha=1.6)
    assert all(torch.equal(o, r) for o, r in zip(out, stream))


def test_solve_runs_every_kernel(dev, monkeypatch):
    """Phase 3's stack on a small fleet runs every kernel of its path (the
    chunk through the cluster kernel), and the same solve with every chunk
    on the streaming kernel gives the same x, statuses and iterations."""
    qp, _ = _fleet(dev, 2, b=8, n=200, m=100)
    st = pt.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4, rho=0.4,
                     check_interval=11, kkt_refinement_steps=0,
                     sigma_free_rhs=True, fused_factor=True, fused_chunk=True,
                     require_fused=True)
    fns = (fused_factor.build_slab, spd_kernels.spd_inverse_unrolled,
           fused_factor.slab_level, fused_admm.fused_admm_chunk)
    for f in fns:
        f.launches = 0
    fused_admm.fused_admm_chunk.variants.clear()
    sol = pt.solve(qp, st)
    assert all(f.launches > 0 for f in fns)
    assert set(fused_admm.fused_admm_chunk.variants) == {
        "highest,G,lanes1,cluster"}
    monkeypatch.setattr(fused_admm, "chunk_kernel", lambda *a, **k: "stream")
    fused_admm.fused_admm_chunk.variants.clear()
    streamed = pt.solve(qp, st)
    assert set(fused_admm.fused_admm_chunk.variants) == {"highest,G,lanes1"}
    monkeypatch.undo()
    assert torch.equal(sol.x, streamed.x)
    assert torch.equal(sol.info.status, streamed.info.status)
    assert torch.equal(sol.info.iterations, streamed.info.iterations)
    ref = pt.solve(qp.to("cpu"), st)
    assert torch.equal(sol.info.status.cpu(), ref.info.status)
    assert (ref.info.status >= 2).all()
    assert float((sol.x.cpu() - ref.x).abs().max()) <= 1e-3


def test_kernels_refuse_what_they_do_not_take(dev):
    qp, _ = _fleet(dev, 3)
    rho = torch.full((B, M), 0.4, device=dev)
    with pytest.raises(ValueError, match="float32"):
        fused_factor.build_slab(qp.P.double(), qp.A.double(), qp.q.double(),
                                rho.double(), 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        fused_factor.build_slab(qp.P.transpose(1, 2), qp.A, qp.q, rho, 1e-6)
    st = pt.Settings(kkt_refinement_steps=0, sigma_free_rhs=True,
                     fused_factor=True, fused_chunk=True, require_fused=True)
    with pytest.raises(ValueError, match="float32"):
        pt.solve(qp.to(torch.float64), st)


def _prox_fleet(dev, seed, b=B, n=N, me=128, mi=128):
    g = torch.Generator(device=dev).manual_seed(seed)
    return device_prox_fleet(b, n, me, mi, generator=g), g


def test_two_block_build_matches_plain(dev):
    prob, _ = _prox_fleet(dev, 4)
    rho = torch.full((B, 256), 0.3, device=dev)
    blocks = (prob.A, prob.C)
    S = fused_factor.build_slab(prob.P, blocks, prob.q, rho, 0.0)
    assert _close(S, fused_factor.build_slab_plain(prob.P, blocks, prob.q,
                                                   rho, 0.0))
    X = fused_factor.fused_factor_solve(prob.P, blocks, prob.q, rho, sigma=0.0)
    Mn = prob.P + 0.3 * (prob.A.transpose(1, 2) @ prob.A
                         + prob.C.transpose(1, 2) @ prob.C)
    R = torch.cat([prob.A.transpose(1, 2), prob.C.transpose(1, 2),
                   prob.q[..., None]], dim=-1)
    assert _close(Mn @ X[..., :257], R)


def test_prox_chunk_kernel_matches_plain(dev):
    prob, g = _prox_fleet(dev, 5)
    rho = torch.rand(B, generator=g, device=dev) * 0.5 + 0.05
    S = fused_factor.fused_factor_solve(
        prob.P, (prob.A, prob.C), prob.q, rho[:, None].expand(B, 256).contiguous(),
        sigma=0.0)
    G, gv = S[..., :256].contiguous(), S[..., 256].contiguous()
    x = torch.randn((B, N), generator=g, device=dev)
    s = torch.rand((B, 128), generator=g, device=dev)
    y = torch.randn((B, 128), generator=g, device=dev)
    z = torch.rand((B, 128), generator=g, device=dev)
    active = torch.arange(B, device=dev) % 4 != 3
    args = (G, prob.A, prob.C, gv, prob.b, prob.d, x, s, y, z, rho, active)
    out = fused_proxqp.fused_proxqp_chunk(*args, K=9)
    ref = fused_proxqp.fused_proxqp_chunk_plain(*args, K=9)
    for o, r, v in zip(out, ref, (x, s, y, z)):
        assert _close(o, r)
        assert torch.equal(o[~active], v[~active])


def test_prox_solve_on_card(dev):
    prob, _ = _prox_fleet(dev, 6, n=200, me=100, mi=60)
    st = pt.ProxQPSettings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4,
                           rho=0.05, adaptive_rho=False, check_interval=25,
                           kkt_warm_start=False, kkt_refinement_steps=0,
                           sigma_free_rhs=True, fused_chunk=True,
                           require_fused=True)
    fns = (fused_factor.build_slab, spd_kernels.spd_inverse_unrolled,
           fused_factor.slab_level, fused_proxqp.fused_proxqp_chunk)
    for f in fns:
        f.launches = 0
    sol = pt.solve_proxqp(prob, st)
    assert all(f.launches > 0 for f in fns)
    assert sol.x.shape == (B, 200)
    ref = pt.solve_proxqp(prob.to("cpu"), st)
    assert torch.equal(sol.info.status.cpu(), ref.info.status)
    assert (ref.info.status == 3).all()
    assert float((sol.x.cpu() - ref.x).abs().max()) <= 1e-3


def test_sweep_routed_inverse_and_solve_on_card(dev):
    """ops/linalg.py routes a sweep-shaped f32 fleet through the pivot
    kernel (4 launches per sweep at n=512) and agrees with torch.linalg."""
    qp, _ = _fleet(dev, 7, n=512, m=256)
    rho = torch.full((B, 256), 0.4, device=dev)
    Mn = qp.P + 1e-4 * torch.eye(512, device=dev) + (
        qp.A.transpose(1, 2) * rho[:, None, :]) @ qp.A
    spd_kernels.spd_inverse_unrolled.launches = 0
    inv = linalg.spd_inverse(Mn)
    X = linalg.spd_solve(Mn, qp.A.transpose(1, 2))
    assert spd_kernels.spd_inverse_unrolled.launches == 8
    ref = torch.linalg.inv(Mn.double())
    assert float((inv.double() - ref).abs().max() / ref.abs().max()) <= 1e-3
    Xr = ref @ qp.A.transpose(1, 2).double()
    assert float((X.double() - Xr).abs().max() / Xr.abs().max()) <= 1e-3


def test_minv_chunk_kernels_match_plain(dev):
    qp, g = _fleet(dev, 8)
    rho = torch.full((B, M), 0.4, device=dev)
    Mn = qp.P + 1e-4 * torch.eye(N, device=dev) + (
        qp.A.transpose(1, 2) * rho[:, None, :]) @ qp.A
    Minv = linalg.spd_inverse(Mn)
    x = torch.randn((B, N), generator=g, device=dev)
    z = torch.randn((B, M), generator=g, device=dev)
    y = torch.randn((B, M), generator=g, device=dev)
    active = torch.arange(B, device=dev) % 3 != 1
    for refine in (0, 1):
        kw = dict(K=7, alpha=1.6, sigma=1e-4, refine=refine)
        args = (Minv, qp.A, qp.P, qp.q, qp.l, qp.u, x, z, y, rho, active)
        out = fused_admm.fused_admm_chunk_minv(*args, **kw)
        ref = fused_admm.fused_admm_chunk_minv_plain(*args, **kw)
        for o, r in zip(out, ref):
            assert _close(o, r)
        assert torch.equal(out[0][~active], x[~active])
        assert torch.equal(out[4][~active], z[~active])

    prob, g = _prox_fleet(dev, 9)
    # The prox fleet's penalty range (chip_smoke.py phase 6). From rho ~ 0.1
    # up, FP32 rounding alone moves these outputs by ~1e-5 on either side:
    # test_minv_prox_kernel_against_f64_witness holds the kernel there.
    rho = 0.0125 * (1.0 + torch.rand(B, generator=g, device=dev))
    Mn = prob.P + 1e-2 * torch.eye(N, device=dev) + rho[:, None, None] * (
        prob.A.transpose(1, 2) @ prob.A + prob.C.transpose(1, 2) @ prob.C)
    Minv = linalg.spd_inverse(Mn)
    x = torch.randn((B, N), generator=g, device=dev)
    s = torch.rand((B, 128), generator=g, device=dev)
    y = torch.randn((B, 128), generator=g, device=dev)
    z = torch.rand((B, 128), generator=g, device=dev)
    active = torch.arange(B, device=dev) % 4 != 3
    for refine in (0, 1):
        kw = dict(K=9, sigma=1e-2, refine=refine)
        args = (Minv, prob.A, prob.C, prob.P, prob.q, prob.b, prob.d, x, s, y,
                z, rho, active)
        out = fused_proxqp.fused_proxqp_chunk_minv(*args, **kw)
        ref = fused_proxqp.fused_proxqp_chunk_minv_plain(*args, **kw)
        for o, r, v in zip(out, ref, (x, s, y, z)):
            assert _close(o, r)
            assert torch.equal(o[~active], v[~active])


@pytest.mark.parametrize("rho_v", [0.1, 0.5])
@pytest.mark.parametrize("refine", [0, 1])
def test_minv_prox_kernel_against_f64_witness(dev, rho_v, refine):
    """At penalties where FP32 rounding moves the outputs past TOL, the
    kernel and its plain version are each held against the plain version in
    f64 on the same inputs: per output, the kernel's error stays within 3x
    the plain version's (rounding gives ratios near 1)."""
    prob, g = _prox_fleet(dev, 14)
    rho = torch.full((B,), rho_v, device=dev)
    Mn = prob.P + 1e-2 * torch.eye(N, device=dev) + rho[:, None, None] * (
        prob.A.transpose(1, 2) @ prob.A + prob.C.transpose(1, 2) @ prob.C)
    Minv = linalg.spd_inverse(Mn)
    x = torch.randn((B, N), generator=g, device=dev)
    s = torch.rand((B, 128), generator=g, device=dev)
    y = torch.randn((B, 128), generator=g, device=dev)
    z = torch.rand((B, 128), generator=g, device=dev)
    active = torch.arange(B, device=dev) % 4 != 3
    args = (Minv, prob.A, prob.C, prob.P, prob.q, prob.b, prob.d, x, s, y, z,
            rho, active)
    kw = dict(K=25, sigma=1e-2, refine=refine)
    ref = fused_proxqp.fused_proxqp_chunk_minv_plain(*args, **kw)
    wit = fused_proxqp.fused_proxqp_chunk_minv_plain(
        *(a.double() if a.is_floating_point() else a for a in args), **kw)
    # The solver's dispatch (the cluster kernel at this shape), and each
    # kernel through its own wrapper.
    for run in (fused_proxqp.fused_proxqp_chunk_minv,
                fused_proxqp.fused_proxqp_chunk_minv_cluster,
                fused_proxqp.fused_proxqp_chunk_minv_streaming):
        out = run(*args, **kw)
        for o, r, w in zip(out, ref, wit):
            ek = float((o.double() - w).abs().max())
            ep = float((r.double() - w).abs().max())
            assert ek <= 3.0 * ep + 1e-7 * float(w.abs().max()), (run.__name__, ek, ep)


def test_default_settings_solves_run_the_minv_kernels(dev):
    qp, _ = _fleet(dev, 10, n=200, m=100)
    st = pt.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4,
                     fused_chunk=True, require_fused=True)
    fns = (spd_kernels.spd_inverse_unrolled, fused_admm.fused_admm_chunk_minv)
    for f in fns:
        f.launches = 0
    sol = pt.solve(qp, st)
    assert all(f.launches > 0 for f in fns)
    ref = pt.solve(qp.to("cpu"), st)
    # Both flags 2 and 3 can pass at one check; which one a lane reports
    # then rests on FP32 rounding, so only "converged" is compared.
    assert (sol.info.status >= 2).all() and (ref.info.status >= 2).all()
    assert float((sol.x.cpu() - ref.x).abs().max()) <= 1e-3

    prob, _ = _prox_fleet(dev, 11, n=200, me=100, mi=60)
    pst = pt.ProxQPSettings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4,
                            rho=0.1, kkt_warm_start=False, fused_chunk=True,
                            require_fused=True)
    fns = (spd_kernels.spd_inverse_unrolled, fused_proxqp.fused_proxqp_chunk_minv)
    for f in fns:
        f.launches = 0
    psol = pt.solve_proxqp(prob, pst)
    assert all(f.launches > 0 for f in fns)
    pref = pt.solve_proxqp(prob.to("cpu"), pst)
    assert torch.equal(psol.info.status.cpu(), pref.info.status)
    assert (pref.info.status == 3).all()
    assert float((psol.x.cpu() - pref.x).abs().max()) <= 1e-3


@pytest.mark.parametrize("n,m", [(384, 128), (1024, 256)])
def test_minv_kernels_at_other_widths(dev, n, m):
    """Widths that take cols_dot's other branches: n = 384 leaves threads
    idle in the row-group split, n = 1024 gives each thread whole columns."""
    qp, g = _fleet(dev, 12, b=4, n=n, m=m)
    rho = torch.full((4, m), 0.4, device=dev)
    Mn = qp.P + 1e-4 * torch.eye(n, device=dev) + (
        qp.A.transpose(1, 2) * rho[:, None, :]) @ qp.A
    Minv = linalg.spd_inverse(Mn)
    ref = torch.linalg.inv(Mn.double())
    assert float((Minv.double() - ref).abs().max() / ref.abs().max()) <= 1e-3
    x = torch.randn((4, n), generator=g, device=dev)
    z = torch.randn((4, m), generator=g, device=dev)
    y = torch.randn((4, m), generator=g, device=dev)
    active = torch.tensor([True, False, True, True], device=dev)
    args = (Minv, qp.A, qp.P, qp.q, qp.l, qp.u, x, z, y, rho, active)
    kw = dict(K=5, alpha=1.6, sigma=1e-4, refine=1)
    for o, r in zip(fused_admm.fused_admm_chunk_minv(*args, **kw),
                    fused_admm.fused_admm_chunk_minv_plain(*args, **kw)):
        assert _close(o, r)

    prob, g = _prox_fleet(dev, 13, b=4, n=n, me=m, mi=m)
    prho = 0.0125 * (1.0 + torch.rand(4, generator=g, device=dev))
    Mn = prob.P + 1e-2 * torch.eye(n, device=dev) + prho[:, None, None] * (
        prob.A.transpose(1, 2) @ prob.A + prob.C.transpose(1, 2) @ prob.C)
    Minv = linalg.spd_inverse(Mn)
    x = torch.randn((4, n), generator=g, device=dev)
    s = torch.rand((4, m), generator=g, device=dev)
    y = torch.randn((4, m), generator=g, device=dev)
    z = torch.rand((4, m), generator=g, device=dev)
    pargs = (Minv, prob.A, prob.C, prob.P, prob.q, prob.b, prob.d, x, s, y, z,
             prho, active)
    pkw = dict(K=5, sigma=1e-2, refine=1)
    for o, r in zip(fused_proxqp.fused_proxqp_chunk_minv(*pargs, **pkw),
                    fused_proxqp.fused_proxqp_chunk_minv_plain(*pargs, **pkw)):
        assert _close(o, r)


def _witness(out, plain, wit):
    """Per output, the kernel's error against the f64 witness (the plain
    version in float64, which runs every precision in full) stays within
    3x the FP32 plain version's: a 1-ulp difference in t can flip a bf16
    rounding, so kernel and plain are not held to TOL at "high"/"default"."""
    for o, p, w in zip(out, plain, wit):
        ek = float((o.double() - w).abs().max())
        ep = float((p.double() - w).abs().max())
        assert bool(torch.isfinite(o).all())
        assert ek <= 3.0 * ep + 1e-7 * float(w.abs().max()), (ek, ep)


def _f64(args):
    return [a.double() if a.is_floating_point() else a for a in args]


def test_admm_chunk_variants_on_card(dev):
    """Each sigma-free variant against its plain version ("high" and
    "default" by the f64 witness), and the bitwise identities: split and
    "high" on the same G, the slab window and the contiguous G, lanes 2 and
    4 and lanes 1; frozen lanes pass through."""
    qp, g = _fleet(dev, 15)
    rho = torch.full((B, M), 0.4, device=dev)
    S = fused_factor.fused_factor_solve(qp.P, qp.A, qp.q, rho, sigma=1e-6)
    G, gv = S[..., :M].contiguous(), S[..., M].contiguous()
    x = torch.randn((B, N), generator=g, device=dev)
    z = torch.randn((B, M), generator=g, device=dev)
    y = torch.randn((B, M), generator=g, device=dev)
    active = torch.arange(B, device=dev) % 3 != 1
    vecs = (qp.l, qp.u, x, z, y, rho, active)
    kw = dict(K=11, alpha=1.6)
    run = fused_admm.fused_admm_chunk
    base = {}
    for prec in ("highest", "high", "default"):
        base[prec] = run(G, qp.A, gv, *vecs, dot_precision=prec, **kw)
        plain = fused_admm.fused_admm_chunk_plain(G, qp.A, gv, *vecs,
                                                  dot_precision=prec, **kw)
        if prec == "highest":
            assert all(_close(o, r) for o, r in zip(base[prec], plain))
        else:
            wit = fused_admm.fused_admm_chunk_plain(
                *_f64((G, qp.A, gv, *vecs)), dot_precision=prec, **kw)
            _witness(base[prec], plain, wit)
        for o, v in zip(base[prec][:5], (x, z, y, x, z)):
            assert torch.equal(o[~active], v[~active])
    Ghi, Glo = linalg.bf16_split(G)
    same = lambda a, b: all(torch.equal(u, v) for u, v in zip(a, b))  # noqa: E731
    assert same(run(Ghi, qp.A, gv, *vecs, dot_precision="high", Glo=Glo, **kw),
                base["high"])
    for prec in ("highest", "high"):
        assert same(run(S, qp.A, gv, *vecs, dot_precision=prec, slab=True, **kw),
                    base[prec])
        for lanes in (2, 4):
            assert same(run(G, qp.A, gv, *vecs, dot_precision=prec,
                            lanes=lanes, **kw), base[prec])
    assert same(run(S, qp.A, gv, *vecs, dot_precision="default", slab=True,
                    lanes=2, **kw), base["default"])
    assert same(run(Ghi, qp.A, gv, *vecs, dot_precision="high", Glo=Glo,
                    lanes=4, **kw), base["high"])


def test_prox_chunk_variants_on_card(dev):
    prob, g = _prox_fleet(dev, 16)
    rho = 0.0125 * (1.0 + torch.rand(B, generator=g, device=dev))
    S = fused_factor.fused_factor_solve(
        prob.P, (prob.A, prob.C), prob.q, rho[:, None].expand(B, 256).contiguous(),
        sigma=0.0)
    G, gv = S[..., :256].contiguous(), S[..., 256].contiguous()
    x = torch.randn((B, N), generator=g, device=dev)
    s = torch.rand((B, 128), generator=g, device=dev)
    y = torch.randn((B, 128), generator=g, device=dev)
    z = torch.rand((B, 128), generator=g, device=dev)
    active = torch.arange(B, device=dev) % 4 != 3
    args = (G, prob.A, prob.C, gv, prob.b, prob.d, x, s, y, z, rho, active)
    run = fused_proxqp.fused_proxqp_chunk
    for prec in ("highest", "high", "default"):
        out = run(*args, K=25, dot_precision=prec)
        plain = fused_proxqp.fused_proxqp_chunk_plain(*args, K=25,
                                                      dot_precision=prec)
        if prec == "highest":
            assert all(_close(o, r) for o, r in zip(out, plain))
        else:
            wit = fused_proxqp.fused_proxqp_chunk_plain(*_f64(args), K=25,
                                                        dot_precision=prec)
            _witness(out, plain, wit)
        for o, v in zip(out, (x, s, y, z)):
            assert torch.equal(o[~active], v[~active])
        for lanes in (2, 4):
            assert all(torch.equal(u, v) for u, v in zip(
                run(*args, K=25, dot_precision=prec, lanes=lanes), out))


@pytest.mark.parametrize("family", ["admm", "prox"])
def test_default_chunk_rounds_like_plain_on_card(dev, family):
    """The witness above cannot fail a "default" kernel that skips a bf16
    rounding (the plain "default" lies far from f64), so: one iteration
    (K=1) of the kernel against its plain version, which rounds the same
    operands, and against the kernel's own "highest". A rounding flipped by
    a 1-ulp sum-order difference moves the few elements that read it, so at
    most 10 % of each output's elements may differ from the plain version by
    more than TOL of its max (a skipped rounding moves 44-99 % of x, y, Ax
    or A'y); every output one iteration moves must differ from "highest" by
    more than 1e-4 of its max."""
    b = 64
    if family == "admm":
        qp, g = _fleet(dev, 21, b=b)
        rho = torch.full((b, M), 0.4, device=dev)
        S = fused_factor.fused_factor_solve(qp.P, qp.A, qp.q, rho, sigma=1e-6)
        args = (S[..., :M].contiguous(), qp.A, S[..., M].contiguous(), qp.l,
                qp.u, *(torch.randn((b, w), generator=g, device=dev)
                        for w in (N, M, M)), rho)
        run, plain, kw = (fused_admm.fused_admm_chunk,
                          fused_admm.fused_admm_chunk_plain, dict(alpha=1.6))
    else:
        prob, g = _prox_fleet(dev, 22, b=b)
        rho = 0.0125 * (1.0 + torch.rand(b, generator=g, device=dev))
        S = fused_factor.fused_factor_solve(
            prob.P, (prob.A, prob.C), prob.q,
            rho[:, None].expand(b, 256).contiguous(), sigma=0.0)
        args = (S[..., :256].contiguous(), prob.A, prob.C,
                S[..., 256].contiguous(), prob.b, prob.d,
                torch.randn((b, N), generator=g, device=dev),
                torch.rand((b, 128), generator=g, device=dev),
                torch.randn((b, 128), generator=g, device=dev),
                torch.rand((b, 128), generator=g, device=dev), rho)
        run, plain, kw = (fused_proxqp.fused_proxqp_chunk,
                          fused_proxqp.fused_proxqp_chunk_plain, {})
    args = (*args, torch.arange(b, device=dev) % 4 != 3)
    out = {(fn, prec): fn(*args, K=1, dot_precision=prec, **kw)
           for fn in (run, plain) for prec in ("default", "highest")}
    for k, p, kh, ph in zip(out[run, "default"], out[plain, "default"],
                            out[run, "highest"], out[plain, "highest"]):
        scale = float(p.abs().max())
        assert bool(torch.isfinite(k).all())
        share = float(((k - p).abs() > TOL * scale).float().mean())
        assert share <= 0.1, share
        if not torch.equal(p, ph):  # x_prev, z_prev are the inputs
            gap = float((k - kh).abs().max()) / float(kh.abs().max())
            assert gap > 1e-4, gap


def test_minv_chunks_with_lanes_on_card(dev):
    """The M^{-1} chunks at lanes 2 and 4 give the bits of lanes 1."""
    qp, g = _fleet(dev, 17)
    rho = torch.full((B, M), 0.4, device=dev)
    Mn = qp.P + 1e-4 * torch.eye(N, device=dev) + (
        qp.A.transpose(1, 2) * rho[:, None, :]) @ qp.A
    Minv = linalg.spd_inverse(Mn)
    x = torch.randn((B, N), generator=g, device=dev)
    z = torch.randn((B, M), generator=g, device=dev)
    y = torch.randn((B, M), generator=g, device=dev)
    active = torch.arange(B, device=dev) % 3 != 1
    args = (Minv, qp.A, qp.P, qp.q, qp.l, qp.u, x, z, y, rho, active)
    kw = dict(K=7, alpha=1.6, sigma=1e-4, refine=1)
    one = fused_admm.fused_admm_chunk_minv(*args, **kw)
    for lanes in (2, 4):
        assert all(torch.equal(u, v) for u, v in zip(
            fused_admm.fused_admm_chunk_minv(*args, lanes=lanes, **kw), one))

    prob, g = _prox_fleet(dev, 18)
    prho = 0.0125 * (1.0 + torch.rand(B, generator=g, device=dev))
    Mn = prob.P + 1e-2 * torch.eye(N, device=dev) + prho[:, None, None] * (
        prob.A.transpose(1, 2) @ prob.A + prob.C.transpose(1, 2) @ prob.C)
    Minv = linalg.spd_inverse(Mn)
    x = torch.randn((B, N), generator=g, device=dev)
    s = torch.rand((B, 128), generator=g, device=dev)
    y = torch.randn((B, 128), generator=g, device=dev)
    z = torch.rand((B, 128), generator=g, device=dev)
    pargs = (Minv, prob.A, prob.C, prob.P, prob.q, prob.b, prob.d, x, s, y, z,
             prho, active)
    pkw = dict(K=9, sigma=1e-2, refine=1)
    one = fused_proxqp.fused_proxqp_chunk_minv(*pargs, **pkw)
    for lanes in (2, 4):
        assert all(torch.equal(u, v) for u, v in zip(
            fused_proxqp.fused_proxqp_chunk_minv(*pargs, lanes=lanes, **pkw), one))


def test_headline_stacks_run_their_variants_on_card(dev):
    """bench.py's slab_settings and the split stack, and the prox headline
    stack, on small fleets: every lane converges, the variants launch, and
    x agrees with the CPU solve (plain versions) within 1e-3."""
    qp, _ = _fleet(dev, 19, n=200, m=100)
    base = dict(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4, rho=0.4,
                check_interval=11, kkt_refinement_steps=0, sigma_free_rhs=True,
                fused_factor=True, fused_chunk=True, require_fused=True,
                adaptive_rho=False, chunk_lanes=2, chunk_dot_precision="high")
    stacks = {"high,slab,lanes2,cluster": dict(
                  slab_cache=True, first_chunk_dot_precision="default"),
              "high,split,lanes2,cluster": dict(split_cache=True)}
    for key, knobs in stacks.items():
        st = pt.Settings(**base, **knobs)
        fused_admm.fused_admm_chunk.variants.clear()
        sol = pt.solve(qp, st)
        counts = fused_admm.fused_admm_chunk.variants
        assert counts[key] > 0, counts
        if "slab" in key:
            assert counts["default,slab,lanes2,cluster"] == 1, counts
        ref = pt.solve(qp.to("cpu"), st)
        assert (sol.info.status.cpu() >= 2).all() and (ref.info.status >= 2).all()
        assert float((sol.x.cpu() - ref.x).abs().max()) <= 1e-3

    prob, _ = _prox_fleet(dev, 20, n=200, me=40, mi=100)
    pst = pt.ProxQPSettings(max_iterations=2000, eps_abs=5e-5, eps_rel=5e-5,
                            rho=0.0125, adaptive_rho=False, check_interval=25,
                            kkt_warm_start=False, kkt_refinement_steps=0,
                            sigma_free_rhs=True, fused_chunk=True,
                            chunk_lanes=2, chunk_dot_precision="high",
                            first_chunk_dot_precision="default",
                            require_fused=True)
    fused_proxqp.fused_proxqp_chunk.variants.clear()
    psol = pt.solve_proxqp(prob, pst)
    counts = fused_proxqp.fused_proxqp_chunk.variants
    assert (counts["default,lanes2,cluster"] == 1
            and counts["high,lanes2,cluster"] > 0), counts
    pref = pt.solve_proxqp(prob.to("cpu"), pst)
    assert (psol.info.status == 3).all() and (pref.info.status == 3).all()
    assert float((psol.x.cpu() - pref.x).abs().max()) <= 1e-3


def _spread_blocks(dev, b, g):
    """SPD blocks with a spread of diagonal magnitudes (X X'/128 + I scaled
    by exp(U(-2, 2)) on each side), made in float64, rounded to float32."""
    X = torch.randn((b, 128, 128), generator=g, device=dev, dtype=torch.float64)
    D = X @ X.transpose(1, 2) / 128 + torch.eye(128, device=dev, dtype=torch.float64)
    s = torch.exp(4 * torch.rand((b, 128), generator=g, device=dev,
                                 dtype=torch.float64) - 2)
    return (D * s[:, :, None] * s[:, None, :]).float()


def test_pivot_formulations_match_plain_on_card(dev):
    """Each pivot formulation's kernel (every rank-q variant q | 128 and the
    panel) against its plain version at B=64, on the slab's pivot blocks (a
    strided view) and on spread-diagonal blocks: TOL, or for "ref" (no
    Jacobi scaling) the f64 witness where FP32 rounding fills TOL; "value"
    and "r1" run v3's kernel, bit for bit; each launch counts under its
    formulation."""
    b = 64
    qp, g = _fleet(dev, 23, b=b)
    rho = torch.full((b, M), 0.4, device=dev)
    S = fused_factor.build_slab(qp.P, qp.A, qp.q, rho, 1e-6)
    kp, j = fused_factor.slab_k(M), N // 128 - 1
    w_out = kp + j * 128
    inv = spd_kernels.spd_inverse_unrolled
    for D in (S[:, j * 128:(j + 1) * 128, w_out:w_out + 128],
              _spread_blocks(dev, b, g)):
        v3 = inv(D)
        assert torch.equal(v3, spd_kernels.pivot_sweep_v3_prev(D))
        for v in ("value", "r1"):
            assert torch.equal(inv(D, variant=v), v3), v
        for v in ("ref", "panel", *(f"r{q}" for q in (2, 4, 8, 16, 32, 64, 128))):
            inv.variants.clear()
            out = inv(D, variant=v)
            assert dict(inv.variants) == {v: 1}
            plain = spd_kernels.pivot_sweep_plain(D, v)
            if not _close(out, plain):
                assert v == "ref", v
                _witness((out,), (plain,),
                         (spd_kernels.pivot_sweep_ref_plain(D.double()),))


def test_slab_level_high_on_card(dev):
    """The bf16x3 level against its plain version (TOL) at B=64; its pivot
    rows apart from the FP32 level's by more than 4e-6 of their max (the
    bf16x3 rounding; FP32 rounding is ~1e-6 of it); the pivot columns
    untouched; one launch counted under "high"."""
    b = 64
    qp, _ = _fleet(dev, 24, b=b)
    rho = torch.full((b, M), 0.4, device=dev)
    Sp = fused_factor.build_slab_plain(qp.P, qp.A, qp.q, rho, 1e-6)
    kp, j = fused_factor.slab_k(M), N // 128 - 1
    w_out, rows = kp + j * 128, slice(j * 128, (j + 1) * 128)
    Dinv = spd_kernels.spd_inverse_unrolled(Sp[:, rows, w_out:w_out + 128])
    Sh, Sf, Sq = Sp.clone(), Sp.clone(), Sp.clone()
    fused_factor.slab_level.variants.clear()
    fused_factor.slab_level(Sh, Dinv, j, w_out, dot_precision="high")
    assert dict(fused_factor.slab_level.variants) == {"high": 1}
    fused_factor.slab_level(Sf, Dinv, j, w_out)
    fused_factor.slab_level_plain(Sq, Dinv, j, w_out, "high")
    assert _close(Sh, Sq)
    assert torch.equal(Sh[..., w_out:], Sp[..., w_out:])
    gap = float((Sh[:, rows, :w_out] - Sf[:, rows, :w_out]).abs().max())
    assert gap > 4e-6 * float(Sf[:, rows, :w_out].abs().max()), gap


@pytest.mark.parametrize("knob", ["ref", "value", "r2", "r4", "r8", "panel", "high"])
def test_factor_knob_solves_on_card(dev, knob):
    """One small fused solve per factor knob with require_fused: every
    factor level launches the named pivot formulation and level precision
    and nothing else, every lane converges, and x agrees with the CPU solve
    (plain versions) within 1e-3."""
    qp, _ = _fleet(dev, 25, b=8, n=200, m=100)   # padded to 256/128: 2 levels
    kw = dict(factor_precision="high") if knob == "high" else dict(pivot_variant=knob)
    st = pt.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4, rho=0.4,
                     check_interval=11, kkt_refinement_steps=0,
                     sigma_free_rhs=True, fused_factor=True, fused_chunk=True,
                     adaptive_rho=False, require_fused=True, **kw)
    inv, level = spd_kernels.spd_inverse_unrolled, fused_factor.slab_level
    inv.variants.clear()
    level.variants.clear()
    sol = pt.solve(qp, st)
    assert dict(inv.variants) == {"v3" if knob == "high" else knob: 2}
    assert dict(level.variants) == {"high" if knob == "high" else "highest": 2}
    ref = pt.solve(qp.to("cpu"), st)
    assert (sol.info.status.cpu() >= 2).all() and (ref.info.status >= 2).all()
    assert float((sol.x.cpu() - ref.x).abs().max()) <= 1e-3


def _gram_blocks(dev, b, nb, g):
    """Pivot-like SPD blocks Dm'Dm/nb + 0.05 I (the pivot shootout's)."""
    Dm = torch.randn((b, nb, nb), generator=g, device=dev)
    return Dm.transpose(1, 2) @ Dm / nb + 0.05 * torch.eye(nb, device=dev)


def test_round1_and_paired_sweeps_match_plain_on_card(dev):
    """The round-1 sweep (row 6) and the paired-64 sweep (row 11) against
    their plain versions at B=64, on gram blocks, spread-diagonal blocks and
    a strided view; one launch counted per call; the zero-pivot guard as its
    plain version."""
    g = torch.Generator(device=dev).manual_seed(26)
    for D in (_gram_blocks(dev, 64, 128, g), _spread_blocks(dev, 64, g)):
        spd_kernels.spd_inverse_nb.launches = 0
        out = spd_kernels.spd_inverse_nb(D)
        assert spd_kernels.spd_inverse_nb.launches == 1
        assert _close(out, spd_kernels.sweep_inverse_block_plain(D, guard_zero=True))
        for D64 in (D[:, :64, :64], D[:, 64:, 64:].contiguous()):
            spd_kernels.spd_inverse_64p.launches = 0
            out = spd_kernels.spd_inverse_64p(D64)
            assert spd_kernels.spd_inverse_64p.launches == 1
            assert _close(out, spd_kernels.pivot_sweep_v3p_plain(D64))
    Dz = _gram_blocks(dev, 8, 128, g)
    Dz[:, 5, :] = 0.0
    Dz[:, :, 5] = 0.0
    out = spd_kernels.spd_inverse_nb(Dz)
    assert torch.isfinite(out).all() and (out[:, 5, 5] == 1.0).all()
    assert _close(out, spd_kernels.sweep_inverse_block_plain(Dz, guard_zero=True))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("b", [4, 64, 512, 3072])
def test_paired_sweep_matches_previous_kernel(dev, b):
    """Row 11's kernel (one 128-thread CTA a 64-block, v3's layout on its
    side) bit for bit its first port, ``pivot_sweep_v3p_prev``, on gram and
    spread-diagonal blocks and on strided views (the leading and trailing
    64-blocks of 128-blocks); one launch counted a call, and none of the
    witness through ``spd_inverse_64p``."""
    g = torch.Generator(device=dev).manual_seed(29)
    big = _gram_blocks(dev, b, 128, g)
    cases = {"gram": _gram_blocks(dev, b, 64, g),
             "spread": _spread_blocks(dev, b, g)[:, 32:96, 32:96].contiguous(),
             "leading": big[:, :64, :64], "trailing": big[:, 64:, 64:]}
    new, prev = spd_kernels.spd_inverse_64p, spd_kernels.pivot_sweep_v3p_prev
    for kind, D in cases.items():
        new.launches = prev.launches = 0
        out = new(D)
        assert (new.launches, prev.launches) == (1, 0), kind
        ref = prev(D)
        assert prev.launches == 1, kind
        assert torch.equal(_bits(out), _bits(ref)), kind
        assert torch.isfinite(out).all(), kind


def test_schur_inverse_on_the_witness(dev, monkeypatch):
    """spd_inverse_128_schur at B=64 launches two paired sweeps and no
    witness, and its output is bit for bit the same Schur step's on the
    witness kernel."""
    g = torch.Generator(device=dev).manual_seed(30)
    D = _gram_blocks(dev, 64, 128, g)
    new, prev = spd_kernels.spd_inverse_64p, spd_kernels.pivot_sweep_v3p_prev
    new.launches = prev.launches = 0
    out = spd_kernels.spd_inverse_128_schur(D)
    assert (new.launches, prev.launches) == (2, 0)
    monkeypatch.setattr(spd_kernels, "spd_inverse_64p",
                        lambda x, lanes=8: prev(x))
    ref = spd_kernels.spd_inverse_128_schur(D)
    assert prev.launches == 2
    assert torch.equal(_bits(out), _bits(ref))


def test_sweep_and_schur_inverses_on_card(dev):
    """spd_inverse_sweep at n=512 (4 row-6 launches) and the Schur inverse at
    B=64 (2 paired launches) against f64 inverses of the same matrices, and
    the Schur inverse's odd-B fallback to v3's kernel."""
    g = torch.Generator(device=dev).manual_seed(27)
    qp, _ = _fleet(dev, 27, n=512, m=256)
    rho = torch.full((B, 256), 0.4, device=dev)
    Mn = qp.P + 1e-4 * torch.eye(512, device=dev) + (
        qp.A.transpose(1, 2) * rho[:, None, :]) @ qp.A
    spd_kernels.spd_inverse_nb.launches = 0
    inv = spd_kernels.spd_inverse_sweep(Mn)
    assert spd_kernels.spd_inverse_nb.launches == 4
    ref = torch.linalg.inv(Mn.double())
    assert float((inv.double() - ref).abs().max() / ref.abs().max()) <= 1e-4
    D = _gram_blocks(dev, 64, 128, g)
    spd_kernels.spd_inverse_64p.launches = 0
    out = spd_kernels.spd_inverse_128_schur(D)
    assert spd_kernels.spd_inverse_64p.launches == 2
    ref = torch.linalg.inv(D.double())
    assert float((out.double() - ref).abs().max() / ref.abs().max()) <= 1e-5
    odd = D[:63]
    assert torch.equal(spd_kernels.spd_inverse_128_schur(odd),
                       spd_kernels.spd_inverse_unrolled(odd, variant="v3"))


def test_normal_inverse_on_card(dev):
    """The fused normal-matrix inverse at n=256, m=128 with per-lane rho
    against its plain version (TOL), against f64 (JAX's limits: residual
    5e-5, relative 1e-5), one launch counted per call."""
    g = torch.Generator(device=dev).manual_seed(28)
    n, m = 256, 128
    W = torch.randn((B, n, n), generator=g, device=dev)
    P = W @ W.transpose(1, 2) / n + 0.1 * torch.eye(n, device=dev)
    A = 0.1 * torch.randn((B, m, n), generator=g, device=dev)
    rho = torch.logspace(-1, 1, B, device=dev)
    spd_kernels.normal_inverse.launches = 0
    out = spd_kernels.normal_inverse(P, A, rho, sigma=1e-6)
    assert spd_kernels.normal_inverse.launches == 1
    assert _close(out, spd_kernels.normal_inverse_plain(P, A, rho, 1e-6))
    M = (P.double() + 1e-6 * torch.eye(n, device=dev, dtype=torch.float64)
         + rho.double()[:, None, None] * A.double().transpose(1, 2) @ A.double())
    eye = torch.eye(n, device=dev, dtype=torch.float64)
    assert float((out.double() @ M - eye).abs().max()) <= 5e-5
    ref = torch.linalg.inv(M)
    assert float((out.double() - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.parametrize("family", ["admm", "prox"])
def test_tf32_on_leaves_the_solve_unchanged(dev, family):
    """bench.py's defaults route (the M^-1 factor through the sweep's
    torch.bmm products, the torch or M^-1 chunk) with TF32 on globally gives
    the x of TF32 off, bit for bit; the caller's flag is left as it was."""
    if family == "admm":
        prob, _ = _fleet(dev, 29, n=512, m=256)
        run = lambda: pt.solve(prob, pt.Settings(  # noqa: E731
            max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4))
    else:
        prob, _ = _prox_fleet(dev, 29, n=256)
        run = lambda: pt.solve_proxqp(prob, pt.ProxQPSettings(  # noqa: E731
            max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4))
    matmul = torch.backends.cuda.matmul
    try:
        matmul.allow_tf32 = False
        off = run()
        matmul.allow_tf32 = True
        on = run()
        assert matmul.allow_tf32
    finally:
        matmul.allow_tf32 = False
    assert torch.equal(on.x, off.x)
    assert torch.equal(on.info.iterations, off.info.iterations)


def _config(dev, n):
    """BASELINE config 4's generator at n (float32 ELL on the card), its
    unscaled P in CSR, and a vector."""
    d = pt.generate_large_sparse_qp(n, seed=0)
    q = pt.make_sparse_qp(d.P, d.q, d.A, d.l, d.u, device=dev)
    return d, q


@pytest.mark.parametrize("n", [3000, 100_000])
def test_spmv_kernels_match_plain_on_card(dev, n):
    """Rows 13, 14 and 15 against their plain versions (TOL) at a small
    size and at config 4 (n = 1e5), one launch counted per call; the routed
    matvecs against scipy in f64 (the probes' 1e-6). The redesigns against
    their witnesses: the masked and unmasked route levels bit for bit
    routed_levels_prev (at S = 8, the unrolled path, and at S = 4 and 16,
    the looped one); the fused row-routed matvec within 1e-6 of max|y|
    of the witness rows summed by index_add_, the same bits on two calls."""
    import numpy as np

    from quadraticprogramsolver_tpu_torch.ops import routed_spmv as rs
    from quadraticprogramsolver_tpu_torch.ops import spmv

    d, q = _config(dev, n)
    g = torch.Generator(device=dev).manual_seed(30)
    for vals, cols in ((q.P_vals, q.P_cols), (q.A_vals, q.A_cols),
                       (q.At_vals, q.At_cols)):
        v = torch.randn(n, generator=g, device=dev)[: int(cols.max()) + 1]
        before = spmv.ell_matvec.launches
        out = spmv.ell_matvec(vals, cols, v)
        assert spmv.ell_matvec.launches == before + 1
        assert _close(out, spmv.ell_matvec_plain(vals, cols, v))
    Pc = d.P.tocsr()
    x_np = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    ref = Pc @ x_np.astype(np.float64)
    x = torch.tensor(x_np, device=dev)

    def scipy_close(y):
        return float(np.abs(y.double().cpu().numpy() - ref).max()
                     / np.abs(ref).max()) <= 1e-6

    RL = rs.route_levels(Pc, 8, rs.probe_width(n), dev)
    X = torch.nn.functional.pad(x, (0, RL.S * RL.W - n)).reshape(RL.W, RL.S)
    X = X.T.contiguous()
    before = rs.routed_levels_matvec.launches
    dense = rs.routed_levels_matvec(X, RL.idxJ, RL.V)
    assert _close(dense, rs.routed_levels_matvec_plain(X, RL.idxJ, RL.V))
    assert scipy_close(rs.routed_matvec(RL, x))
    assert rs.routed_levels_matvec.launches == before + 2
    masked = rs.routed_levels_matvec(X, RL.idxJ, RL.V, RL.mask)
    assert rs.routed_levels_matvec.launches == before + 3
    before = rs.routed_levels_prev.launches
    prev = rs.routed_levels_prev(X, RL.idxJ, RL.V)
    assert rs.routed_levels_prev.launches == before + 1
    assert torch.equal(dense, prev) and torch.equal(masked, prev)
    # The level-split kernel's looped path (S other than 8), over several
    # levels: at S = 4 more than one round of level groups (T > 16 at n =
    # 1e5), at S = 16 one part-filled round.
    for S in (4, 16):
        RL = rs.route_levels(Pc, S, -(-n // (S * 128)) * 128, dev)
        assert RL.idxJ.shape[1] > 1
        X = torch.nn.functional.pad(x, (0, RL.S * RL.W - n)).reshape(RL.W, S)
        X = X.T.contiguous()
        prev = rs.routed_levels_prev(X, RL.idxJ, RL.V)
        assert torch.equal(rs.routed_levels_matvec(X, RL.idxJ, RL.V), prev)
        assert torch.equal(rs.routed_levels_matvec(X, RL.idxJ, RL.V, RL.mask),
                           prev)
        assert _close(prev, rs.routed_levels_matvec_plain(X, RL.idxJ, RL.V))
    del RL, X, prev
    RR = rs.row_routed(Pc, dev)
    Xw = torch.nn.functional.pad(x, (0, RR.n_win * 128 - n)).reshape(RR.n_win, 128)
    rows = rs.row_routed_rows(Xw, RR.idx, RR.V, RR.L)
    assert torch.equal(rows, rs.row_routed_rows_plain(Xw, RR.idx, RR.V, RR.L))
    wit = rs.block_sum(rows, RR.order, RR.blk_ptr)
    before = rs.row_routed_blocks.launches
    y_blk = rs.row_routed_blocks(Xw, RR.idx, RR.V, RR.mask, RR.order,
                                 RR.blk_ptr, RR.L)
    assert rs.row_routed_blocks.launches == before + 1
    assert torch.equal(y_blk, rs.row_routed_blocks(
        Xw, RR.idx, RR.V, RR.mask, RR.order, RR.blk_ptr, RR.L))
    assert float((y_blk - wit).abs().max()) <= 1e-6 * float(wit.abs().max())
    assert _close(y_blk, rs.row_routed_blocks_plain(
        Xw, RR.idx, RR.V, RR.mask, RR.order, RR.blk_ptr, RR.L))
    before = (rs.row_routed_blocks.launches, rs.row_routed_rows.launches)
    assert scipy_close(rs.row_routed_matvec(RR, x))
    assert (rs.row_routed_blocks.launches, rs.row_routed_rows.launches) == (
        before[0] + 1, before[1])
    # The square micro kernel (one level), at two of the probe's shapes.
    for S, W, G in ((8, 256, 96), (784, 128, 64)):
        X = torch.randn((S, W), generator=g, device=dev)
        idx = torch.randint(0, W, (G, S, W), generator=g, device=dev,
                            dtype=torch.int32)
        V = torch.randn((G, S, W), generator=g, device=dev)
        assert _close(rs.routed_levels_matvec(X, idx, V),
                      rs.routed_levels_matvec_plain(X, idx, V))


def test_spmv_kernels_refuse_what_they_do_not_take(dev):
    import numpy as np

    from quadraticprogramsolver_tpu_torch.ops import routed_spmv as rs
    from quadraticprogramsolver_tpu_torch.ops import spmv

    _, q = _config(dev, 500)
    v = torch.randn(500, device=dev)
    vals, cols = q.P_vals, q.P_cols
    for bad in ((vals.double(), cols, v), (vals, cols.long(), v),
                (vals, cols, v.double()), (vals.T, cols.T, v),
                (vals, cols[:-1], v)):
        with pytest.raises(ValueError):
            spmv.ell_matvec(*bad)
    X = torch.randn((8, 128), device=dev)
    idx = torch.randint(0, 128, (4, 8, 128), device=dev, dtype=torch.int32)
    V = torch.randn((4, 8, 128), device=dev)
    for bad in ((X.double(), idx, V), (X, idx.long(), V), (X, idx, V.double()),
                (X[:4], idx, V)):
        with pytest.raises(ValueError):
            rs.routed_levels_matvec(*bad)
    Xw = torch.randn((4, 128), device=dev)
    r_idx = torch.randint(0, 128, (8, 128), device=dev, dtype=torch.int32)
    r_V = torch.randn((8, 128), device=dev)
    for bad in ((Xw.double(), r_idx, r_V, 2), (Xw, r_idx.long(), r_V, 2),
                (Xw, r_idx, r_V, 1)):
        with pytest.raises(ValueError):
            rs.row_routed_rows(*bad)
    # The masked route levels: a mask of another dtype or shape.
    mask = _u32(np.full((4, 1, 8, 4), 2 ** 32 - 1), dev)
    assert torch.equal(rs.routed_levels_matvec(X, idx, V, mask),
                       rs.routed_levels_matvec(X, idx, V))
    for bad in (mask.view(torch.int32), mask[..., :3], mask[:, :, :4]):
        with pytest.raises(ValueError):
            rs.routed_levels_matvec(X, idx, V, bad)
    with pytest.raises(ValueError):
        rs.routed_levels_prev(X, idx.long(), V)
    # The fused row-routed matvec: wrong dtypes or shapes of the mask and
    # the index, a width other than 128, a misaligned operand.
    r_mask = _u32(np.zeros((8, 4)), dev)
    order = torch.arange(8, device=dev, dtype=torch.int32)
    ptr = torch.tensor([0, 4, 8], device=dev, dtype=torch.int32)
    ok = (Xw, r_idx, r_V, r_mask, order, ptr, 2)
    assert not rs.row_routed_blocks(*ok).any()
    for pos, bad in ((3, r_mask.view(torch.int32)), (3, r_mask[:, :3]),
                     (3, r_mask[:4]), (4, order.long()), (4, order[None]),
                     (5, ptr.long()), (5, ptr[None]), (0, Xw.double()),
                     (1, r_idx.long()), (0, Xw[:, :64]), (1, r_idx[:, :64]),
                     (6, 1)):
        args = list(ok)
        args[pos] = bad
        with pytest.raises(ValueError):
            rs.row_routed_blocks(*args)
    shifted = torch.empty(129, device=dev)[1:].reshape(1, 128)
    with pytest.raises(ValueError, match="aligned"):
        rs.row_routed_blocks(shifted, r_idx[:2], r_V[:2], r_mask[:2],
                             order[:2], ptr[:2] // 2, 2)


def _u32(a, dev):
    """A uint32 tensor on the card from numpy values (a host copy: the
    card's uint32 support is copies and views)."""
    import numpy as np

    return torch.from_numpy(np.asarray(a).astype(np.uint32)).to(dev)


def test_sparse_solve_on_card(dev):
    """A small config-4 instance (n = 2000, ELL, float32) at
    benchmarks/large_sparse.py's settings reaches SOLVED through row 13's
    kernel; CSR storage launches no kernel of ours; a float64 ELL solve on
    the card raises (the kernel takes float32)."""
    import numpy as np

    from quadraticprogramsolver_tpu_torch.ops import spmv

    d = pt.generate_large_sparse_qp(2000, seed=1)
    args = (d.P, d.q, d.A, d.l, d.u)
    st = pt.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4, rho=0.1,
                     cg_eps=1e-6, cg_max_iterations=200, cg_rel_eps=1e-4)
    before = spmv.ell_matvec.launches
    sol = pt.solve(pt.make_sparse_qp(*args, device=dev), st)
    assert int(sol.info.status) == 3
    assert spmv.ell_matvec.launches > before
    before = spmv.ell_matvec.launches
    csr = pt.solve(pt.make_sparse_qp(*args, storage="bcoo", device=dev), st)
    assert int(csr.info.status) >= 2 and spmv.ell_matvec.launches == before
    assert float((csr.x - sol.x).abs().max()) <= 1e-2
    with pytest.raises(ValueError, match="float32"):
        pt.solve(pt.make_sparse_qp(*args, dtype=np.float64, device=dev), st)


@pytest.mark.parametrize("b", [4, 5, 512])
def test_pivot_v3_kernel_matches_previous_kernel(dev, b):
    """Row 2's kernel (two 256-thread CTAs an SM, the block in registers)
    against the port's first v3 kernel, bit for bit, and its plain version
    (TOL): on contiguous well-conditioned blocks, the slab's last pivot
    block read through its strides (d_row = the slab's pitch) and
    spread-diagonal blocks."""
    qp, g = _fleet(dev, 30, b=b)
    rho = torch.full((b, M), 0.4, device=dev)
    S = fused_factor.build_slab(qp.P, qp.A, qp.q, rho, 1e-6)
    kp, j = fused_factor.slab_k(M), N // 128 - 1
    w_out = kp + j * 128
    slab_view = S[:, j * 128:(j + 1) * 128, w_out:w_out + 128]
    assert slab_view.stride(1) == S.shape[-1]
    X = torch.randn((b, 128, 128), generator=g, device=dev, dtype=torch.float64)
    wellc = (X @ X.transpose(1, 2) / 128 + torch.eye(128, device=dev,
                                                     dtype=torch.float64)).float()
    inv = spd_kernels.spd_inverse_unrolled
    for D in (wellc, slab_view, _spread_blocks(dev, b, g)):
        inv.variants.clear()
        spd_kernels.pivot_sweep_v3_prev.launches = 0
        new = inv(D)
        prev = spd_kernels.pivot_sweep_v3_prev(D)
        assert dict(inv.variants) == {"v3": 1}
        assert spd_kernels.pivot_sweep_v3_prev.launches == 1
        assert torch.equal(new, prev)
        assert _close(new, spd_kernels.pivot_sweep_v3_plain(D))


def _chunk_operands(dev, seed, b, n, m):
    qp, g = _fleet(dev, seed, b=b, n=n, m=m)
    rho = torch.full((b, m), 0.4, device=dev)
    S = fused_factor.fused_factor_solve(qp.P, qp.A, qp.q, rho, sigma=1e-6)
    G, gv = S[..., :m].contiguous(), S[..., m].contiguous()
    x = torch.randn((b, n), generator=g, device=dev)
    z = torch.randn((b, m), generator=g, device=dev)
    y = torch.randn((b, m), generator=g, device=dev)
    active = torch.arange(b, device=dev) % 4 != 3
    return S, G, (qp.A, gv, qp.l, qp.u, x, z, y, rho, active)


@pytest.mark.parametrize("K", [1, 11])
@pytest.mark.parametrize("n,m", [(512, 256), (128, 128), (256, 384)])
def test_cluster_chunk_matches_streaming_kernel(dev, n, m, K):
    """Row 4a's cluster kernel (G and A held in a cluster's registers) against
    the streaming kernel, bit for bit on all seven outputs, from a contiguous
    G and from the slab window, every fourth lane frozen; and against the
    plain version (TOL)."""
    S, G, rest = _chunk_operands(dev, 31, 8, n, m)
    x, z, active = rest[4], rest[5], rest[8]
    kw = dict(K=K, alpha=1.6)
    stream = fused_admm.fused_admm_chunk_streaming(G, *rest, **kw)
    plain = fused_admm.fused_admm_chunk_plain(G, *rest, **kw)
    assert all(_close(o, r) for o, r in zip(stream, plain))
    for Gsrc, slab in ((G, False), (S, True)):
        fused_admm.fused_admm_chunk_cluster.launches = 0
        out = fused_admm.fused_admm_chunk_cluster(Gsrc, *rest, slab=slab, **kw)
        assert fused_admm.fused_admm_chunk_cluster.launches == 1
        for o, r in zip(out, stream):
            assert torch.equal(o, r)
        assert torch.equal(out[0][~active], x[~active])
        assert torch.equal(out[3][~active], x[~active])
        assert torch.equal(out[4][~active], z[~active])


#: The sigma-free cluster variants beside "highest": (precision, G source).
CLUSTER_VARIANTS = [("high", "G"), ("high", "slab"), ("high", "split"),
                    ("default", "G"), ("default", "slab")]


@pytest.mark.parametrize("K", [1, 11])
@pytest.mark.parametrize("n,m", [(512, 256), (256, 384), (384, 256)])
@pytest.mark.parametrize("prec,src", CLUSTER_VARIANTS)
def test_cluster_chunk_variants_match_streaming_kernel(dev, prec, src, n, m, K):
    """Each "high" and "default" cluster instance (G packed as bf16 halves
    or rounded to bf16 in registers, t and xx exchanged in their operand
    form) against the streaming kernel of the same variant, bit for bit on
    all seven outputs, every fourth lane frozen, with more lanes than twice
    the clusters resident at once (not a multiple of them)."""
    resident = fused_admm.cluster_occupancy(n, m, prec)
    assert resident >= 1
    S, G, rest = _chunk_operands(dev, 34, 2 * resident + 3, n, m)
    x, z, active = rest[4], rest[5], rest[8]
    kw = dict(K=K, alpha=1.6, dot_precision=prec)
    if src == "split":
        G, kw["Glo"] = linalg.bf16_split(G)
    elif src == "slab":
        G, kw["slab"] = S, True
    stream = fused_admm.fused_admm_chunk_streaming(G, *rest, **kw)
    fused_admm.fused_admm_chunk_cluster.launches = 0
    out = fused_admm.fused_admm_chunk_cluster(G, *rest, **kw)
    assert fused_admm.fused_admm_chunk_cluster.launches == 1
    for o, r in zip(out, stream):
        assert torch.equal(o, r)
    assert torch.equal(out[0][~active], x[~active])
    assert torch.equal(out[4][~active], z[~active])
    assert bool(torch.isfinite(out[5]).all() and torch.isfinite(out[6]).all())


def test_chunk_dispatch_on_card(dev):
    """The solver's chunk runs the cluster kernel wherever the lane fits a
    cluster's registers and shared memory, at any lanes and precision and
    from any G source (lanes 2 giving lanes 1's bits); a lane over
    capacity counts under the streaming key."""
    S, G, rest = _chunk_operands(dev, 32, 4, 256, 128)
    run, counts = fused_admm.fused_admm_chunk, fused_admm.fused_admm_chunk.variants
    counts.clear()
    base = run(G, *rest, K=3, alpha=1.6)
    run(S, *rest, K=3, alpha=1.6, slab=True)
    lanes2 = run(G, *rest, K=3, alpha=1.6, lanes=2)
    run(G, *rest, K=3, alpha=1.6, dot_precision="high")
    assert dict(counts) == {"highest,G,lanes1,cluster": 1,
                            "highest,slab,lanes1,cluster": 1,
                            "highest,G,lanes2,cluster": 1,
                            "high,G,lanes1,cluster": 1}
    assert all(torch.equal(o, r) for o, r in zip(lanes2, base))
    # Over the cluster's registers: random operands (the fleet's factor
    # is not needed to hold one kernel against another).
    n, m, b = 1024, 512, 2
    assert fused_admm.chunk_kernel(n, m, 1, "highest", "G") == "stream"
    g = torch.Generator(device=dev).manual_seed(33)
    G = torch.randn((b, n, m), generator=g, device=dev) / n
    rest = (torch.randn((b, m, n), generator=g, device=dev) / n,
            *(torch.randn((b, w), generator=g, device=dev) for w in (n,)),
            -torch.rand((b, m), generator=g, device=dev),
            torch.rand((b, m), generator=g, device=dev),
            *(torch.randn((b, w), generator=g, device=dev) for w in (n, m, m)),
            torch.full((b, m), 0.4, device=dev),
            torch.ones(b, dtype=torch.bool, device=dev))
    counts.clear()
    out = run(G, *rest, K=2, alpha=1.6)
    assert dict(counts) == {"highest,G,lanes1": 1}
    with pytest.raises(ValueError, match="do not fit"):
        fused_admm.fused_admm_chunk_cluster(G, *rest, K=2, alpha=1.6)
    for o, r in zip(out, fused_admm.fused_admm_chunk_plain(G, *rest, K=2,
                                                           alpha=1.6)):
        assert _close(o, r)


def _prox_chunk_operands(dev, seed, b, n, me, mi):
    """A prox fleet's sigma-free cache (from one stacked block [A; C]: the
    same G = M^{-1}[A' C']) and iterates at phase 6's penalties, every
    fourth lane frozen."""
    prob, g = _prox_fleet(dev, seed, b=b, n=n, me=me, mi=mi)
    # Phase 6's penalties: from rho ~ 0.1 up, FP32 rounding alone moves K=25
    # iterations past TOL of the plain version.
    rho = 0.0125 * (1.0 + torch.rand(b, generator=g, device=dev))
    mt = me + mi
    S = fused_factor.fused_factor_solve(
        prob.P, torch.cat([prob.A, prob.C], 1), prob.q,
        rho[:, None].expand(b, mt).contiguous(), sigma=0.0)
    G, gv = S[..., :mt].contiguous(), S[..., mt].contiguous()
    x = torch.randn((b, n), generator=g, device=dev)
    s = torch.rand((b, mi), generator=g, device=dev)
    y = torch.randn((b, me), generator=g, device=dev)
    z = torch.rand((b, mi), generator=g, device=dev)
    active = torch.arange(b, device=dev) % 4 != 3
    return (G, prob.A, prob.C, gv, prob.b, prob.d, x, s, y, z, rho, active)


@pytest.mark.parametrize("K", [1, 25])
@pytest.mark.parametrize("n,me,mi", [(128, 64, 64), (256, 128, 128),
                                     (512, 128, 128), (512, 64, 192)])
def test_prox_cluster_chunk_matches_streaming_kernel(dev, n, me, mi, K):
    """Row 5a's cluster kernel (G, A and C held in a cluster's registers)
    against the streaming kernel, bit for bit on x, s, y and z, with every
    fourth lane frozen and more lanes than twice the clusters resident at
    once (not a multiple of them); and against the plain version (TOL)."""
    resident = fused_proxqp.cluster_occupancy(n, me, mi)
    assert resident >= 1
    args = _prox_chunk_operands(dev, 40, 2 * resident + 3, n, me, mi)
    active = args[-1]
    stream = fused_proxqp.fused_proxqp_chunk_streaming(*args, K=K)
    plain = fused_proxqp.fused_proxqp_chunk_plain(*args, K=K)
    assert all(_close(o, r) for o, r in zip(stream, plain))
    fused_proxqp.fused_proxqp_chunk_cluster.launches = 0
    out = fused_proxqp.fused_proxqp_chunk_cluster(*args, K=K)
    assert fused_proxqp.fused_proxqp_chunk_cluster.launches == 1
    for o, r, v in zip(out, stream, args[6:10]):
        assert torch.equal(o, r)
        assert torch.equal(o[~active], v[~active])


@pytest.mark.parametrize("K", [1, 25])
@pytest.mark.parametrize("n,me,mi", [(512, 128, 128), (128, 64, 64),
                                     (512, 64, 192), (256, 128, 256)])
@pytest.mark.parametrize("prec", ["high", "default"])
def test_prox_cluster_chunk_variants_match_streaming_kernel(dev, prec, n, me, mi, K):
    """The prox cluster kernel at "high" (G and [A; C] packed as bf16
    halves) and "default" against the streaming kernel of the same
    precision, bit for bit on x, s, y and z, every fourth lane frozen, more
    lanes than twice the clusters resident (not a multiple of them)."""
    resident = fused_proxqp.cluster_occupancy(n, me, mi, prec)
    assert resident >= 1
    args = _prox_chunk_operands(dev, 42, 2 * resident + 3, n, me, mi)
    active = args[-1]
    stream = fused_proxqp.fused_proxqp_chunk_streaming(*args, K=K,
                                                       dot_precision=prec)
    fused_proxqp.fused_proxqp_chunk_cluster.launches = 0
    out = fused_proxqp.fused_proxqp_chunk_cluster(*args, K=K, dot_precision=prec)
    assert fused_proxqp.fused_proxqp_chunk_cluster.launches == 1
    for o, r, v in zip(out, stream, args[6:10]):
        assert torch.equal(o, r)
        assert torch.equal(o[~active], v[~active])


def test_prox_solve_runs_the_cluster_chunk(dev):
    """The prox solve's chunk runs the cluster kernel at "highest" and at
    "high" (n=200, me=100, mi=60 padded to 256/128/128); the cluster
    solve's statuses are the CPU solve's, x within 1e-3."""
    prob, _ = _prox_fleet(dev, 41, n=200, me=100, mi=60)
    base = dict(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4, rho=0.05,
                adaptive_rho=False, check_interval=25, kkt_warm_start=False,
                kkt_refinement_steps=0, sigma_free_rhs=True, fused_chunk=True,
                require_fused=True)
    counts = fused_proxqp.fused_proxqp_chunk.variants
    counts.clear()
    st = pt.ProxQPSettings(**base)
    sol = pt.solve_proxqp(prob, st)
    assert set(counts) == {"highest,lanes1,cluster"}, counts
    counts.clear()
    pt.solve_proxqp(prob, pt.ProxQPSettings(chunk_dot_precision="high", **base))
    assert set(counts) == {"high,lanes1,cluster"}, counts
    ref = pt.solve_proxqp(prob.to("cpu"), st)
    assert (ref.info.status == 3).all()
    assert torch.equal(sol.info.status.cpu(), ref.info.status)
    assert float((sol.x.cpu() - ref.x).abs().max()) <= 1e-3


def _random_ell(dev, g, rows, k, n):
    """Random ELL arrays: each row's first U(0, k) slots hold values and
    columns, the rest the padding (value 0, column 0)."""
    vals = torch.randn((rows, k), generator=g, device=dev)
    cols = torch.randint(0, n, (rows, k), generator=g, device=dev, dtype=torch.int32)
    used = torch.randint(0, k + 1, (rows, 1), generator=g, device=dev)
    pad = torch.arange(k, device=dev)[None, :] >= used
    return vals.masked_fill(pad, 0.0), cols.masked_fill(pad, 0)


@pytest.mark.parametrize("rows", [1, 255, 257, 100_000])
def test_ell_matvec_matches_plain_and_previous_kernel(dev, rows):
    """Row 13's kernel within TOL of its plain version and of the kernel it
    replaced, at every k (the 16-byte path at k % 4 == 0, else scalar; the
    scalar path also from 4-byte aligned arrays), one launch each."""
    from quadraticprogramsolver_tpu_torch.ops import spmv

    n = 5000
    g = torch.Generator(device=dev).manual_seed(rows)
    v = torch.randn(n, generator=g, device=dev)
    for k in (1, 2, 3, 4, 5, 8, 11, 17, 32, 33, 44, 64, 100):
        vals, cols = _random_ell(dev, g, rows, k, n)
        plain = spmv.ell_matvec_plain(vals, cols, v)
        before = (spmv.ell_matvec.launches, spmv.ell_matvec_prev.launches)
        out = spmv.ell_matvec(vals, cols, v)
        prev = spmv.ell_matvec_prev(vals, cols, v)
        assert (spmv.ell_matvec.launches, spmv.ell_matvec_prev.launches) == (
            before[0] + 1, before[1] + 1)
        assert _close(out, plain) and _close(out, prev) and _close(prev, plain), k
        # The same arrays 4 bytes past a 16-byte boundary.
        vb = torch.empty(rows * k + 1, device=dev)[1:].view(rows, k)
        cb = torch.empty(rows * k + 1, device=dev, dtype=torch.int32)[1:].view(rows, k)
        vb.copy_(vals)
        cb.copy_(cols)
        assert _close(spmv.ell_matvec(vb, cb, v), plain), k


# -- rows 1 and 3: the triangle build and the strip level --


def _factor_operands(dev, seed, b, n, ms):
    """P (a random_qp fleet's), row blocks of rows ``ms``, q and per-row
    rho in [0.1, 1.1), made on the card from a seed."""
    qp, g = _fleet(dev, seed, b=b, n=n, m=sum(ms))
    blocks = tuple(qp.A[:, o:o + mb].contiguous()
                   for o, mb in zip((0, *ms[:-1]), ms))
    rho = 0.1 + torch.rand((b, sum(ms)), generator=g, device=dev)
    return qp.P, blocks, qp.q, rho


#: Row 3's bf16x6 level against float64, over the FP32 witness's error
#: (``slab_level_prev`` at "highest", sequential fmaf sums): at most GATE
#: times, max relative and relative Frobenius alike.
GATE = 1.5


def _errors(x, ref):
    """(max |x - ref| / max |ref|, ||x - ref||_F / ||ref||_F)."""
    d = x.double() - ref
    return float(d.abs().max() / ref.abs().max()), float(d.norm() / ref.norm())


def _within_gate(new, prev, ref):
    """The gate on ``new`` and ``prev`` against ``ref``: (passes, errors)."""
    e_new, e_prev = _errors(new, ref), _errors(prev, ref)
    return all(a <= GATE * b for a, b in zip(e_new, e_prev)), (e_new, e_prev)


@pytest.mark.parametrize("b", [1, 300])
@pytest.mark.parametrize("m", [64, 128, 256])
@pytest.mark.parametrize("n", [128, 256, 512])
def test_strip_level_matches_previous_kernel(dev, n, m, b):
    """Row 3's strip kernel (bf16x6 on the tensor cores, one launch a
    level) held to the previous two-launch FP32 level (``slab_level_prev``)
    at every level j: its error against a float64 run of the level within
    GATE of the witness's, max relative and relative Frobenius; within TOL
    of the plain bf16x6 level (``_dot6``, the kernel's arithmetic); the
    pivot columns untouched. m = 64 gives w_out % 128 == 0 (kp = 128), m =
    128 and 256 give 64 (kp = 192, 320: a 64-wide last strip); n = 128 has
    no row block but the pivots'; B = 300 is more than two waves (one CTA
    an SM on 132 SMs)."""
    P, A, q, rho = _factor_operands(dev, 40, b, n, (m,))
    S = fused_factor.build_slab(P, A, q, rho, 1e-6)
    kp = fused_factor.slab_k(m)
    assert kp % 128 == {64: 0, 128: 64, 256: 64}[m]
    for j in range(n // 128 - 1, -1, -1):
        w_out = kp + j * 128
        Dinv = spd_kernels.spd_inverse_unrolled(
            S[:, j * 128:(j + 1) * 128, w_out:w_out + 128])
        new, mirror = S.clone(), S.clone()
        ref = S.double()
        fused_factor.slab_level.variants.clear()
        fused_factor.slab_level_prev.launches = 0
        fused_factor.slab_level(new, Dinv, j, w_out)
        fused_factor.slab_level_prev(S, Dinv, j, w_out)
        assert dict(fused_factor.slab_level.variants) == {"highest": 1}
        assert fused_factor.slab_level_prev.launches == 1
        fused_factor.slab_level_plain(ref, Dinv.double(), j, w_out)
        rows = slice(j * 128, (j + 1) * 128)
        DinvT = fused_factor._dot6(Dinv, mirror[:, rows, :w_out])
        mirror[..., :w_out] -= fused_factor._dot6(
            mirror[..., w_out:w_out + 128], DinvT)
        mirror[:, rows, :w_out] = DinvT
        assert torch.isfinite(new).all()
        assert torch.equal(new[..., w_out:], S[..., w_out:]), j
        ok, errs = _within_gate(new[..., :w_out], S[..., :w_out], ref[..., :w_out])
        assert ok, (j, errs)
        assert _close(new, mirror), j


@pytest.mark.parametrize("shape", [(256, 128, 300, None), (512, 256, 64, 0.4),
                                   (512, 128, 1, None)],
                         ids=["n256_b300", "cells_draw", "n512_b1"])
def test_strip_factor_holds_fp32_error(dev, shape):
    """The whole factor (``fused_factor_solve``: one build, the pivot
    sweeps, the x6 strip levels) against a float64 run of the same slab
    (float64 levels, torch.linalg.inv pivots): X = S[..., :kp] within GATE
    of the FP32 witness factor's error (the same build and pivot kernels,
    every level through ``slab_level_prev``), max relative and relative
    Frobenius. "cells_draw" is the benchmark cells' generator at n = 512,
    m = 256, rho 0.4."""
    n, m, b, rho0 = shape
    P, A, q, rho = _factor_operands(dev, 44, b, n, (m,))
    if rho0 is not None:
        rho = torch.full_like(rho, rho0)
    kp = fused_factor.slab_k(m)
    fused_factor.slab_level.variants.clear()
    X = fused_factor.fused_factor_solve(P, A, q, rho, sigma=1e-6)[..., :kp]
    assert dict(fused_factor.slab_level.variants) == {"highest": n // 128}
    W = fused_factor.build_slab(P, A, q, rho, 1e-6)
    S64 = W.double()
    for j in range(n // 128 - 1, -1, -1):
        w_out, rows = kp + j * 128, slice(j * 128, (j + 1) * 128)
        fused_factor.slab_level_prev(W, spd_kernels.spd_inverse_unrolled(
            W[:, rows, w_out:w_out + 128]), j, w_out)
        fused_factor.slab_level_plain(
            S64, torch.linalg.inv(S64[:, rows, w_out:w_out + 128]), j, w_out)
    ok, errs = _within_gate(X, W[..., :kp], S64[..., :kp])
    assert ok, errs


@pytest.mark.parametrize("ms", [(256,), (128, 128), (48, 80)])
@pytest.mark.parametrize("n", [128, 512])
def test_triangle_build_matches_previous_kernel(dev, n, ms):
    """Row 1's triangle kernel against the previous kernels
    (``build_slab_prev``), one and two row blocks: [A' | q | 0] and the
    upper triangle of M bit for bit; the gram part of M exactly symmetric
    (M is P plus the mirrored gram of a P = 0 build, element for element);
    within 1e-6 of the previous kernel relative to max(|prev|, 1), which
    rounds rho_r A[r, j] where the mirror rounds rho_r A[r, i]."""
    b = 37
    P, A, q, rho = _factor_operands(dev, 41, b, n, ms)
    kp = fused_factor.slab_k(sum(ms))
    assert fused_factor.build_kernel(n) == "triangle"
    fused_factor.build_slab.variants.clear()
    fused_factor.build_slab_prev.launches = 0
    new = fused_factor.build_slab(P, A, q, rho, 1e-6)
    prev = fused_factor.build_slab_prev(P, A, q, rho, 1e-6)
    gram = fused_factor.build_slab(torch.zeros_like(P), A, q, rho, 1e-6)[..., kp:]
    assert dict(fused_factor.build_slab.variants) == {"triangle": 2}
    assert fused_factor.build_slab_prev.launches == 1
    assert torch.equal(new[..., :kp], prev[..., :kp])
    upper = torch.ones((n, n), dtype=torch.bool, device=dev).triu()
    M, Mp = new[..., kp:], prev[..., kp:]
    assert torch.equal(M[:, upper], Mp[:, upper])
    assert torch.equal(gram, gram.transpose(1, 2))
    assert torch.equal(M, P + gram)
    err = float((M - Mp).abs().max()) / max(float(Mp.abs().max()), 1.0)
    assert err <= 1e-6, err


def test_build_keeps_the_square_kernel_off_128(dev):
    """At n % 128 == 64 the rule sends the build to the previous kernels:
    bit for bit ``build_slab_prev``."""
    P, A, q, rho = _factor_operands(dev, 43, 5, 192, (64, 32))
    assert fused_factor.build_kernel(192) == "square"
    fused_factor.build_slab.variants.clear()
    S = fused_factor.build_slab(P, A, q, rho, 1e-6)
    assert dict(fused_factor.build_slab.variants) == {"square": 1}
    assert torch.equal(S, fused_factor.build_slab_prev(P, A, q, rho, 1e-6))


def test_high_level_keeps_the_two_launch_kernel(dev):
    """The two-launch bf16x3 level stays as the strip kernel's witness:
    slab_level_prev(..., dot_precision="high") is bit for bit a direct call
    of its C entry point at prec 1, one witness launch counted and none of
    slab_level's."""
    from quadraticprogramsolver_tpu_torch import _build

    b, n, m = 16, 512, 256
    P, A, q, rho = _factor_operands(dev, 44, b, n, (m,))
    S = fused_factor.build_slab(P, A, q, rho, 1e-6)
    kp, j = fused_factor.slab_k(m), n // 128 - 1
    w_out = kp + j * 128
    Dinv = spd_kernels.spd_inverse_unrolled(S[:, j * 128:, w_out:w_out + 128])
    Sh, Sd = S.clone(), S.clone()
    fused_factor.slab_level.variants.clear()
    fused_factor.slab_level_prev.launches = 0
    fused_factor.slab_level_prev(Sh, Dinv, j, w_out, dot_precision="high")
    assert fused_factor.slab_level_prev.launches == 1
    assert not fused_factor.slab_level.variants
    scratch = torch.empty((b, 128, w_out), device=dev)
    code = _build.load().lib.qps_slab_level(
        Sd.data_ptr(), Dinv.data_ptr(), scratch.data_ptr(), w_out, b, n,
        S.shape[-1], j, w_out, 1, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert code == 0
    assert torch.equal(Sh, Sd)


@pytest.mark.parametrize("ms", [(256,), (128, 128)])
def test_redesigned_factor_matches_plain(dev, ms):
    """The whole factor (1 triangle build, 4 strip levels, no witness
    launch) within TOL of its plain version on the card, both families'
    shapes at n = 512."""
    b, n = 16, 512
    P, A, q, rho = _factor_operands(dev, 45, b, n, ms)
    m = sum(ms)
    fused_factor.build_slab.variants.clear()
    fused_factor.slab_level.variants.clear()
    fused_factor.build_slab_prev.launches = 0
    fused_factor.slab_level_prev.launches = 0
    X = fused_factor.fused_factor_solve(P, A, q, rho, sigma=1e-6)
    assert dict(fused_factor.build_slab.variants) == {"triangle": 1}
    assert dict(fused_factor.slab_level.variants) == {"highest": 4}
    assert fused_factor.build_slab_prev.launches == 0
    assert fused_factor.slab_level_prev.launches == 0
    Sp = fused_factor.build_slab_plain(P, A, q, rho, 1e-6)
    kp = fused_factor.slab_k(m)
    for j in range(n // 128 - 1, -1, -1):
        w_out = kp + j * 128
        D = Sp[:, j * 128:(j + 1) * 128, w_out:w_out + 128]
        fused_factor.slab_level_plain(Sp, spd_kernels.pivot_sweep_v3_plain(D),
                                      j, w_out)
    assert _close(X[..., :m + 1], Sp[..., :m + 1])


# -- rows 4b and 5b: the M^{-1}-form chunks held on chip by a cluster --


def _mismatches(out, ref, names):
    """The outputs that are not bit for bit equal, with their max |diff|."""
    return {k: float((o - r).abs().max()) for k, o, r in zip(names, out, ref)
            if not torch.equal(o, r)}


def _minv_operands(dev, seed, b, n, m):
    """An ADMM fleet's M^{-1} (rho 0.4, sigma 1e-4) and random iterates,
    every fourth lane frozen."""
    qp, g = _fleet(dev, seed, b=b, n=n, m=m)
    rho = torch.full((b, m), 0.4, device=dev)
    Mn = qp.P + 1e-4 * torch.eye(n, device=dev) + (
        qp.A.transpose(1, 2) * rho[:, None, :]) @ qp.A
    # Off the sweep's shapes (n = 640) the inverse is a Cholesky one, not
    # contiguous.
    Minv = linalg.spd_inverse(Mn).contiguous()
    x = torch.randn((b, n), generator=g, device=dev)
    z = torch.randn((b, m), generator=g, device=dev)
    y = torch.randn((b, m), generator=g, device=dev)
    active = torch.arange(b, device=dev) % 4 != 3
    return (Minv, qp.A, qp.P, qp.q, qp.l, qp.u, x, z, y, rho, active)


@pytest.mark.parametrize("refine", [0, 1, 2])
@pytest.mark.parametrize("K", [1, 25])
@pytest.mark.parametrize("n,m", [(512, 256), (256, 384)])
def test_minv_cluster_chunk_matches_streaming_kernel(dev, n, m, K, refine):
    """Row 4b's cluster kernel (M^{-1} and A rows in a cluster's registers,
    A's columns and P's rows in its shared memory) against the streaming
    kernel, bit for bit on all seven outputs, every fourth lane frozen,
    more lanes than twice the clusters resident at once; and against the
    plain version (TOL)."""
    resident = fused_admm.minv_cluster_occupancy(n, m, refine)
    assert resident >= 1
    args = _minv_operands(dev, 50, 2 * resident + 3, n, m)
    x, z, active = args[6], args[7], args[10]
    kw = dict(K=K, alpha=1.6, sigma=1e-4, refine=refine)
    stream = fused_admm.fused_admm_chunk_minv_streaming(*args, **kw)
    plain = fused_admm.fused_admm_chunk_minv_plain(*args, **kw)
    assert all(_close(o, r) for o, r in zip(stream, plain))
    fused_admm.fused_admm_chunk_minv_cluster.launches = 0
    out = fused_admm.fused_admm_chunk_minv_cluster(*args, **kw)
    assert fused_admm.fused_admm_chunk_minv_cluster.launches == 1
    bad = _mismatches(out, stream, ("x", "z", "y", "x_prev", "z_prev", "Ax", "ATy"))
    assert not bad, bad
    assert torch.equal(out[0][~active], x[~active])
    assert torch.equal(out[3][~active], x[~active])
    assert torch.equal(out[4][~active], z[~active])


def _prox_minv_operands(dev, seed, b, n, me, mi, rho0=None):
    """A prox fleet's M^{-1} (sigma 1e-2) at phase 6's penalties, or at one
    rho0 for every lane, and random iterates, every fourth lane frozen."""
    prob, g = _prox_fleet(dev, seed, b=b, n=n, me=me, mi=mi)
    if rho0 is None:
        rho = 0.0125 * (1.0 + torch.rand(b, generator=g, device=dev))
    else:
        rho = torch.full((b,), rho0, device=dev)
    Mn = prob.P + 1e-2 * torch.eye(n, device=dev) + rho[:, None, None] * (
        prob.A.transpose(1, 2) @ prob.A + prob.C.transpose(1, 2) @ prob.C)
    Minv = linalg.spd_inverse(Mn)
    x = torch.randn((b, n), generator=g, device=dev)
    s = torch.rand((b, mi), generator=g, device=dev)
    y = torch.randn((b, me), generator=g, device=dev)
    z = torch.rand((b, mi), generator=g, device=dev)
    active = torch.arange(b, device=dev) % 4 != 3
    return (Minv, prob.A, prob.C, prob.P, prob.q, prob.b, prob.d, x, s, y, z,
            rho, active)


@pytest.mark.parametrize("refine", [0, 1, 2])
@pytest.mark.parametrize("K", [1, 25])
@pytest.mark.parametrize("rho0", [None, 0.1])
@pytest.mark.parametrize("n,me,mi", [(512, 128, 128), (256, 128, 256)])
def test_prox_minv_cluster_chunk_matches_streaming_kernel(dev, n, me, mi, rho0, K,
                                                         refine):
    """Row 5b's cluster kernel (M^{-1} and [A; C] rows in a cluster's
    registers, [A; C]'s columns and P's rows in its shared memory) against
    the streaming kernel, bit for bit on x, s, y and z, every fourth lane
    frozen, more lanes than twice the clusters resident at once, at phase
    6's penalties and at 7c's rho0 = 0.1."""
    resident = fused_proxqp.minv_cluster_occupancy(n, me, mi, refine)
    assert resident >= 1
    args = _prox_minv_operands(dev, 51, 2 * resident + 3, n, me, mi, rho0)
    active = args[-1]
    kw = dict(K=K, sigma=1e-2, refine=refine)
    stream = fused_proxqp.fused_proxqp_chunk_minv_streaming(*args, **kw)
    fused_proxqp.fused_proxqp_chunk_minv_cluster.launches = 0
    out = fused_proxqp.fused_proxqp_chunk_minv_cluster(*args, **kw)
    assert fused_proxqp.fused_proxqp_chunk_minv_cluster.launches == 1
    bad = _mismatches(out, stream, ("x", "s", "y", "z"))
    assert not bad, bad
    for o, v in zip(out, args[7:11]):
        assert torch.equal(o[~active], v[~active])


def test_minv_chunk_dispatch_on_card(dev):
    """The solver's M^{-1} chunks run the cluster kernels at lanes 1 and 2
    (the same bits), and stream off the cluster's shapes."""
    args = _minv_operands(dev, 52, 4, 256, 128)
    run, counts = fused_admm.fused_admm_chunk_minv, fused_admm.fused_admm_chunk_minv.variants
    counts.clear()
    kw = dict(K=3, alpha=1.6, sigma=1e-4, refine=1)
    one = run(*args, **kw)
    two = run(*args, lanes=2, **kw)
    assert dict(counts) == {"lanes1,cluster": 1, "lanes2,cluster": 1}
    assert all(torch.equal(o, r) for o, r in zip(one, two))
    pargs = _prox_minv_operands(dev, 53, 4, 256, 128, 128)
    prun, pcounts = (fused_proxqp.fused_proxqp_chunk_minv,
                     fused_proxqp.fused_proxqp_chunk_minv.variants)
    pcounts.clear()
    pkw = dict(K=3, sigma=1e-2, refine=1)
    one = prun(*pargs, **pkw)
    two = prun(*pargs, lanes=2, **pkw)
    assert dict(pcounts) == {"lanes1,cluster": 1, "lanes2,cluster": 1}
    assert all(torch.equal(o, r) for o, r in zip(one, two))
    # n = 640 is over the cluster's registers: the streaming kernel.
    args = _minv_operands(dev, 54, 2, 640, 128)
    counts.clear()
    out = run(*args, **kw)
    assert dict(counts) == {"lanes1": 1}
    with pytest.raises(ValueError, match="do not fit"):
        fused_admm.fused_admm_chunk_minv_cluster(*args, **kw)
    assert all(_close(o, r) for o, r in zip(
        out, fused_admm.fused_admm_chunk_minv_plain(*args, **kw)))


# -- rows 6, 7 and 12: the unscaled sweep in v3's register layout, and the
# -- normal inverse in place on sgemm.cuh --

def _resident_sweeps(dev):
    """Sweep CTAs resident at once: two an SM."""
    return 2 * torch.cuda.get_device_properties(dev).multi_processor_count


#: Each form of sweep_block_kernel with an entry point of its own: (the
#: entry point's kernel, its witness, its plain version). "ref" is called
#: through the kernel route directly: spd_inverse_unrolled inverts B < 4 by
#: Cholesky.
SWEEP_FORMS = {
    "guard": (spd_kernels.spd_inverse_nb, spd_kernels.pivot_sweep_2d_prev,
              lambda D: spd_kernels.sweep_inverse_block_plain(D, guard_zero=True)),
    "fold": (lambda D: spd_kernels._pivot_sweep_cuda(D, "ref"),
             spd_kernels.pivot_sweep_ref_prev, spd_kernels.pivot_sweep_ref_plain),
}


@pytest.mark.parametrize("form", sorted(SWEEP_FORMS))
def test_sweep_block_matches_previous_kernel(dev, form):
    """Rows 6 (GUARD) and 7 (FOLD): the sweep in v3's register layout (two
    256-thread CTAs an SM) against the first port (sweep_block_prev_kernel),
    bit for bit, one launch each counted, and against its plain version
    (TOL, or the f64 witness where FP32 rounding fills it): on
    well-conditioned and spread-diagonal blocks, a pivot block of a larger
    matrix read through its strides, B = 1 and B = 2 x resident CTAs + 3;
    under GUARD also a zero pivot, read as 1."""
    new, prev, plain = SWEEP_FORMS[form]
    g = torch.Generator(device=dev).manual_seed(60)
    big = _gram_blocks(dev, 8, 384, g)
    strided = big[:, 128:256, 128:256]
    assert strided.stride(1) == 384
    many = _gram_blocks(dev, 2 * _resident_sweeps(dev) + 3, 128, g)
    cases = [_gram_blocks(dev, 16, 128, g), _spread_blocks(dev, 16, g), strided,
             many[:1], many]
    if form == "guard":
        Dz = _gram_blocks(dev, 8, 128, g)
        Dz[:, 5, :] = 0.0
        Dz[:, :, 5] = 0.0
        cases.append(Dz)
    for D in cases:
        prev.launches = 0
        out, wit = new(D), prev(D)
        assert prev.launches == 1
        assert torch.equal(out, wit), (form, tuple(D.shape))
        ref = plain(D)
        if not _close(out, ref):
            _witness((out,), (ref,), (plain(D.double()),))
    if form == "guard":
        assert (out[:, 5, 5] == 1.0).all() and torch.isfinite(out).all()


def _normal_operands(dev, seed, b, n, m):
    g = torch.Generator(device=dev).manual_seed(seed)
    W = torch.randn((b, n, n), generator=g, device=dev)
    P = W @ W.transpose(1, 2) / n + 0.1 * torch.eye(n, device=dev)
    A = 0.1 * torch.randn((b, m, n), generator=g, device=dev)
    return P, A, torch.logspace(-1, 1, b, device=dev)


@pytest.mark.parametrize("n, m", [(128, 128), (256, 128), (512, 256)])
def test_normal_inverse_matches_previous_kernel(dev, n, m):
    """Row 12 in place on sgemm.cuh against the first port's two-buffer
    sequence (normal_inverse_prev), bit for bit, with per-lane rho in [0.1,
    10]; both within TOL of the plain version; one counted launch each. At n
    = 128 the inverse is one unguarded pivot sweep (sweep_block_kernel
    without GUARD or FOLD), there also at B = 1 and B = 2 x resident CTAs +
    3."""
    sizes = (8, 1, 2 * _resident_sweeps(dev) + 3) if n == 128 else (8,)
    for b in sizes:
        P, A, rho = _normal_operands(dev, 61 + n, b, n, m)
        spd_kernels.normal_inverse.launches = 0
        spd_kernels.normal_inverse_prev.launches = 0
        out = spd_kernels.normal_inverse(P, A, rho, sigma=1e-6)
        wit = spd_kernels.normal_inverse_prev(P, A, rho, sigma=1e-6)
        assert spd_kernels.normal_inverse.launches == 1
        assert spd_kernels.normal_inverse_prev.launches == 1
        assert torch.equal(out, wit), (n, m, b)
        assert _close(out, spd_kernels.normal_inverse_plain(P, A, rho, 1e-6))


def test_normal_inverse_allocates_no_working_copy(dev):
    """The in-place sequence allocates the output and its two small
    workspaces (CD, Dinv) and no second (B, n, n) matrix: its peak lies below
    the witness's by the witness's second working matrix and its (B, 128, n)
    scratch."""
    b, n, m = 64, 512, 256
    P, A, rho = _normal_operands(dev, 62, b, n, m)
    peaks = {}
    for fn in (spd_kernels.normal_inverse, spd_kernels.normal_inverse_prev):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(P, A, rho, sigma=1e-6)
        torch.cuda.synchronize()
        peaks[fn.__name__] = torch.cuda.max_memory_allocated() - base
        del out
    own = 4 * b * (n * n + n * 128 + 128 * 128)
    assert peaks["normal_inverse"] <= own + (1 << 20), peaks
    assert peaks["normal_inverse_prev"] - peaks["normal_inverse"] >= 4 * b * (
        n * n + 128 * n), peaks


# -- rows 3b, 9 and 10: the bf16x3 strip level, and the rank-q and panel
# -- sweeps in v3's register layout --


@pytest.mark.parametrize("b", [5, 300])
@pytest.mark.parametrize("ms", [(64,), (128,), (64, 64)],
                         ids=["m64", "m128", "two_blocks"])
@pytest.mark.parametrize("n", [128, 256, 512])
def test_strip_level_high_matches_previous_kernel(dev, n, ms, b):
    """Row 3b's strip kernel (one launch a level on the tensor cores) bit
    for bit the two-launch bf16x3 level (``slab_level_prev`` at "high") on
    the whole slab, at every level j: m = 64 gives w_out % 128 == 0, m =
    128 (one block or two of 64 rows) gives 64, a 64-wide last strip; B =
    300 is more than one wave; and within TOL of its plain version."""
    P, A, q, rho = _factor_operands(dev, 46, b, n, ms)
    S = fused_factor.build_slab(P, A, q, rho, 1e-6)
    kp = fused_factor.slab_k(sum(ms))
    for j in range(n // 128 - 1, -1, -1):
        w_out = kp + j * 128
        Dinv = spd_kernels.spd_inverse_unrolled(
            S[:, j * 128:(j + 1) * 128, w_out:w_out + 128])
        new, plain = S.clone(), S.clone()
        fused_factor.slab_level.variants.clear()
        fused_factor.slab_level_prev.launches = 0
        fused_factor.slab_level(new, Dinv, j, w_out, dot_precision="high")
        fused_factor.slab_level_prev(S, Dinv, j, w_out, dot_precision="high")
        assert dict(fused_factor.slab_level.variants) == {"high": 1}
        assert fused_factor.slab_level_prev.launches == 1
        assert torch.isfinite(S).all()
        assert torch.equal(new, S), j
        fused_factor.slab_level_plain(plain, Dinv, j, w_out, "high")
        assert _close(new, plain), j


#: The group formulations whose kernel is group_sweep_kernel: every q
#: dividing 16 and the panel.
WARP_GROUPS = ["r2", "r4", "r8", "r16", "panel"]


@pytest.mark.parametrize("variant", WARP_GROUPS)
def test_group_sweep_matches_previous_kernel(dev, variant):
    """Rows 9 and 10: the group sweep in v3's register layout against the
    first port (``pivot_sweep_group_prev``), bit for bit, one launch each
    counted: on well-conditioned and spread-diagonal blocks, a pivot block
    of a larger matrix read through its strides, B = 4 and B = 2 x resident
    CTAs + 3; and within TOL of its plain version."""
    g = torch.Generator(device=dev).manual_seed(63)
    big = _gram_blocks(dev, 8, 384, g)
    strided = big[:, 128:256, 128:256]
    assert spd_kernels.group_kernel(variant) == "warp"
    inv, prev = spd_kernels.spd_inverse_unrolled, spd_kernels.pivot_sweep_group_prev
    for D in (_gram_blocks(dev, 16, 128, g), _spread_blocks(dev, 16, g), strided,
              _gram_blocks(dev, 4, 128, g),
              _gram_blocks(dev, 2 * _resident_sweeps(dev) + 3, 128, g)):
        inv.variants.clear()
        prev.launches = 0
        out, wit = inv(D, variant=variant), prev(D, variant)
        assert dict(inv.variants) == {variant: 1}
        assert prev.launches == 1
        assert torch.equal(out, wit), (variant, tuple(D.shape))
        assert _close(out, spd_kernels.pivot_sweep_plain(D, variant))


@pytest.mark.parametrize("variant", ["r32", "r64", "r128"])
def test_wide_groups_keep_the_first_kernel(dev, variant):
    """q >= 32 (a group spans warps) stays on the first port: the entry
    point is bit for bit its witness wrapper, counted under the variant."""
    g = torch.Generator(device=dev).manual_seed(64)
    D = _spread_blocks(dev, 8, g)
    assert spd_kernels.group_kernel(variant) == "block"
    inv = spd_kernels.spd_inverse_unrolled
    inv.variants.clear()
    out = inv(D, variant=variant)
    assert dict(inv.variants) == {variant: 1}
    assert torch.equal(out, spd_kernels.pivot_sweep_group_prev(D, variant))


def _witness_factor(P, A, q, rho, pivot_variant, dot_precision):
    """The fused factor through the pivot witnesses: each pivot block
    through pivot_sweep_group_prev (or v3's kernel); each "high" level
    through the two-launch slab_level_prev, each "highest" one through the
    strip kernel (bf16x6, which its own test holds to the two-launch FP32
    level's error: no witness gives its bits)."""
    n, m = q.shape[-1], rho.shape[-1]
    kp = fused_factor.slab_k(m)
    S = fused_factor.build_slab(P, A, q, rho, 1e-6)
    for j in range(n // 128 - 1, -1, -1):
        w_out = kp + j * 128
        D = S[:, j * 128:(j + 1) * 128, w_out:w_out + 128]
        Dinv = (spd_kernels.pivot_sweep_v3_prev(D) if pivot_variant == "v3"
                else spd_kernels.pivot_sweep_group_prev(D, pivot_variant))
        if dot_precision == "high":
            fused_factor.slab_level_prev(S, Dinv, j, w_out, dot_precision="high")
        else:
            fused_factor.slab_level(S, Dinv, j, w_out)
    return S


@pytest.mark.parametrize("ms", [(256,), (128, 128)], ids=["one_block", "two_blocks"])
@pytest.mark.parametrize("knob", ["r2", "r4", "r8", "panel", "high"])
def test_knob_factor_matches_witness_factor(dev, knob, ms):
    """Phases 9c-9g's fused factors at n = 512, both families' shapes, bit
    for bit the same factor through the pivot and "high" level witnesses
    (their parent's kernels): four launches of the knob's kernel and none
    of a witness."""
    b, n = 16, 512
    P, A, q, rho = _factor_operands(dev, 47, b, n, ms)
    pivot, prec = ("v3", "high") if knob == "high" else (knob, "highest")
    spd_kernels.spd_inverse_unrolled.variants.clear()
    fused_factor.slab_level.variants.clear()
    spd_kernels.pivot_sweep_group_prev.launches = 0
    fused_factor.slab_level_prev.launches = 0
    S = fused_factor.fused_factor_solve(P, A, q, rho, sigma=1e-6,
                                        pivot_variant=pivot, dot_precision=prec)
    assert dict(spd_kernels.spd_inverse_unrolled.variants) == {pivot: 4}
    assert dict(fused_factor.slab_level.variants) == {prec: 4}
    assert spd_kernels.pivot_sweep_group_prev.launches == 0
    assert fused_factor.slab_level_prev.launches == 0
    assert torch.equal(S, _witness_factor(P, A, q, rho, pivot, prec))


def _core_solve_on_card(dev, qp, st, fns, prepare=False):
    """One solve with the launch counters of ``fns`` at 0 before it, and the
    same port solve of the f64 copy on the CPU."""
    for f in fns:
        f.launches = 0
    if prepare:
        sol = pt.solve(qp, st, prepared=pt.prepare(qp, st))
    else:
        sol = pt.solve(qp, st)
    launches = {f.__name__: f.launches for f in fns}
    assert all(v > 0 for v in launches.values()), launches
    cpu = qp.to("cpu", torch.float64)
    ref = (pt.solve(cpu, st, prepared=pt.prepare(cpu, st)) if prepare
           else pt.solve(cpu, st))
    # Flags 2 and 3 can pass at one check; which one a lane reports then
    # rests on rounding, so "converged" is what is compared.
    assert (sol.info.status >= 2).all() and (ref.info.status >= 2).all()
    assert float((sol.x.cpu().double() - ref.x).abs().max()) <= 1e-3
    return sol, launches


def test_scaled_minv_solve_on_card(dev):
    """scaling_iters with the M^{-1} chunk at refinement 2 (the 9-class
    sweep's settings): the auto-pad, then equilibration, then rows 2 and
    4b."""
    qp, _ = _fleet(dev, 20, n=200, m=100)
    st = pt.Settings(max_iterations=4000, eps_abs=1e-4, eps_rel=1e-4,
                     rho=0.1, kkt_refinement_steps=2, scaling_iters=10,
                     fused_chunk=True, require_fused=True)
    assert pt.plan(qp, st).padded == (256, 128)
    _core_solve_on_card(dev, qp, st, (spd_kernels.spd_inverse_unrolled,
                                      fused_admm.fused_admm_chunk_minv))


def test_anderson_solve_on_card(dev):
    qp, _ = _fleet(dev, 21, n=256, m=128)
    st = pt.Settings(max_iterations=4000, eps_abs=1e-4, eps_rel=1e-4,
                     rho=0.1, check_interval=25, anderson_memory=8,
                     record_history=True, fused_chunk=True,
                     require_fused=True)
    sol, _ = _core_solve_on_card(dev, qp, st, (
        spd_kernels.spd_inverse_unrolled, fused_admm.fused_admm_chunk_minv))
    h = sol.info.history["res_prim"]
    ran = int(sol.info.iterations.max()) // st.check_interval
    assert h.shape == (st.num_checks, B)
    assert bool(h[:ran].isfinite().all()) and bool(h[ran:].isinf().all())


def test_polished_solve_on_card(dev):
    """polish's two inverses (H at n, S at m) go through row 2's sweep."""
    qp, _ = _fleet(dev, 22, n=256, m=128)
    st = pt.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4,
                     polish_iterations=3, fused_chunk=True,
                     require_fused=True)
    _, launches = _core_solve_on_card(dev, qp, st, (
        spd_kernels.spd_inverse_unrolled, fused_admm.fused_admm_chunk_minv))
    # The factor (2 blocks) and at least H (2) and S (1).
    assert launches["spd_inverse_unrolled"] >= 2 + 2 + 1


def test_prepared_sigma_free_solve_on_card(dev):
    qp, _ = _fleet(dev, 23, n=256, m=128)
    st = pt.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4,
                     rho=0.4, adaptive_rho=False, check_interval=11,
                     kkt_refinement_steps=0, sigma_free_rhs=True,
                     fused_chunk=True, require_fused=True)
    assert pt.plan(qp, st, prepared=True).factor == "prepared"
    _core_solve_on_card(dev, qp, st, (spd_kernels.spd_inverse_unrolled,
                                      fused_admm.fused_admm_chunk),
                        prepare=True)


# --- The KKT_LDL and KKT_MINRES backends and the matrix-free prox path ------

@pytest.mark.parametrize("kind", ["KKT_LDL", "KKT_MINRES"])
def test_kkt_backend_solve_on_card(dev, kind):
    """A fleet through LDL or MINRES on the card against the port's CPU f64
    solve of the same fleet: every lane converged in both (flags 2 and 3 can
    pass at one check, and which one a lane reports rests on rounding: the
    CPU's own f32 solve flips 2 of these 8 lanes against its f64 one, on
    CHOLESKY too), x within 1e-4."""
    import numpy as np

    qp = pt.generate_batch(pt.ProblemClass.RANDOM_QP, B, 64, seed=5,
                           dtype=np.float32, device=dev)
    st = pt.Settings(max_iterations=4000, eps_abs=1e-5, eps_rel=1e-5,
                     rho=0.1, kkt_backend=pt.KKTBackendKind[kind])
    sol = pt.solve(qp, st)
    ref = pt.solve(qp.to("cpu", torch.float64), st)
    assert bool((sol.info.status >= 2).all()) and bool((ref.info.status >= 2).all())
    assert float((sol.x.cpu().double() - ref.x).abs().max()) <= 1e-4


def test_minres_preconditioner_launches_row_2_once(dev):
    """MINRES's dense preconditioner (P + sigma I)^{-1} is built once a
    solve through row 2's sweep (n = 128: one launch); a rho refactor is
    free."""
    import numpy as np

    qp = pt.generate_batch(pt.ProblemClass.RANDOM_QP, B, 128, seed=6,
                           dtype=np.float32, device=dev)
    st = pt.Settings(max_iterations=1000, eps_abs=1e-4, eps_rel=1e-4,
                     rho=0.1, kkt_backend=pt.KKTBackendKind.KKT_MINRES)
    spd_kernels.spd_inverse_unrolled.launches = 0
    sol = pt.solve(qp, st)
    assert spd_kernels.spd_inverse_unrolled.launches == 1
    assert bool((sol.info.status >= 2).all())


def test_sparse_prox_solve_on_card(dev):
    """The n = 2000 monotone smoothing problem (large_smoothing.py's, f32)
    as a SparseProxQP with ELL storage (row 13 in every product) against CSR
    storage (no kernel of ours) on the card: the same status, x within
    1e-4, and the ELL solve piecewise monotone within its primal residual,
    which f64 recomputes within 10 % of the reported one (400 f32
    iterations leave steps of the residual's size against the monotone
    direction: 1e-6 or more here)."""
    import numpy as np
    import scipy.sparse as sp

    from quadraticprogramsolver_tpu_torch.ops import spmv
    from quadraticprogramsolver_tpu_torch.problems.operators import (
        monotone_smoothing_sparse_qp)

    n = 2000
    rng = np.random.default_rng(0)
    y = np.sin(np.pi * np.linspace(0, 1, n)) + 0.05 * rng.standard_normal(n)
    P, q, C, d = monotone_smoothing_sparse_qp(
        y, np.array([0, n // 2, n - 1]), smooth_order=2, lam=50.0)
    A = sp.csr_matrix(([1.0], ([0], [0])), shape=(1, n))
    args = (P, q, A, np.array([y[0]]), C, d)
    st = pt.ProxQPSettings(max_iterations=400, eps_abs=1e-5, eps_rel=1e-5,
                           cg_eps=1e-10, cg_max_iterations=300,
                           cg_rel_eps=1e-4)
    before = spmv.ell_matvec.launches
    ell = pt.solve_proxqp(pt.make_sparse_proxqp(*args, device=dev), st)
    assert spmv.ell_matvec.launches > before
    before = spmv.ell_matvec.launches
    csr = pt.solve_proxqp(pt.make_sparse_proxqp(*args, storage="bcoo",
                                                device=dev), st)
    assert spmv.ell_matvec.launches == before
    assert int(ell.info.status) == int(csr.info.status)
    assert float((ell.x - csr.x).abs().max()) <= 1e-4
    x, s = (t.double().cpu().numpy() for t in (ell.x, ell.s))
    res_prim = max(abs(x[0] - y[0]), float(np.abs(C @ x - d + s).max()))
    assert abs(res_prim - float(ell.info.res_prim)) <= 0.1 * res_prim
    steps = np.concatenate([-np.diff(x[: n // 2 + 1]), np.diff(x[n // 2:])])
    assert steps.max() <= max(1e-6, res_prim)


# --------------------------------------------- reduced product precision

def _f64_from_bf16(a, b, prec):
    """The f64 product of a and b as the precision reads them."""
    if prec == "default":
        return linalg.bf16_round(a).double() @ linalg.bf16_round(b).double()
    ah, al = (h.double() for h in linalg.bf16_split(a))
    bh, bl = (h.double() for h in linalg.bf16_split(b))
    return ah @ bh + ah @ bl + al @ bh


@pytest.mark.parametrize("prec", ["default", "high"])
def test_bf16_products_match_plain_on_card(dev, prec):
    """The card's bf16 products (cuBLAS, FP32 output) within 1e-6 of the max
    of an f64 recomputation from the same bf16-rounded operands, and of the
    CPU's plain version, on every operand layout the solvers use: batched,
    a shared 2-D operand on either side, matvecs, the in-place update; at
    "highest" the helpers are torch.matmul, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(16, 256, 512, generator=g, device=dev)
    b = torch.randn(16, 512, 128, generator=g, device=dev)
    v = torch.randn(16, 512, generator=g, device=dev)

    def rel(x, ref):
        return float((x.double() - ref).abs().max() / ref.abs().max())

    cases = [(lambda: linalg.mm(a, b), a, b),
             (lambda: linalg.mm(a, b[0]), a, b[0]),
             (lambda: linalg.mm(a[0], b), a[0], b),
             (lambda: linalg.mv(a, v), a, v[..., None]),
             (lambda: linalg.mv_t(a.transpose(1, 2), v), v[:, None, :], a.transpose(1, 2))]
    with linalg.products(prec):
        for fn, x, y in cases:
            out = fn()
            ref = _f64_from_bf16(x, y, prec).reshape(out.shape)
            assert out.dtype == torch.float32 and rel(out, ref) <= 1e-6
            plain = linalg.mm(x.cpu(), y.cpu()).reshape(out.shape)
            assert rel(out.cpu(), plain.double()) <= 1e-6
        W = torch.zeros(16, 256, 128, device=dev)
        linalg.sub_mm_(W, a, b)
        assert rel(-W, _f64_from_bf16(a, b, prec)) <= 1e-6
    assert torch.equal(linalg.mm(a, b), torch.matmul(a, b))


def test_default_factor_on_card(dev):
    """One "default" factor off the slab on the card (the M^{-1} route at
    n=256: 2 pivot launches, FP32): an approximate inverse, far from the
    FP32 factor (> 1e-4 of its max) yet a contraction for refinement
    (||I - M~^{-1} M||_2 < 0.5), as the CPU's plain version's is."""
    from quadraticprogramsolver_tpu_torch.models import kkt

    qp, _ = _fleet(dev, 9)
    rho = torch.full((B,), 0.3, device=dev)
    st = pt.Settings(factor_precision="default")
    spd_kernels.spd_inverse_unrolled.launches = 0
    Mi = kkt.cholesky_init(qp, rho, 1e-4, st)["M_inv"]
    assert spd_kernels.spd_inverse_unrolled.launches == N // 128
    full = kkt.cholesky_init(qp, rho, 1e-4, pt.Settings())["M_inv"]
    assert float((Mi - full).abs().max()) > 1e-4 * float(full.abs().max())
    M64 = kkt._build_normal_matrix(qp.to(torch.float64),
                                   rho[:, None].double().expand(B, M), 1e-4)
    E = torch.eye(N, device=dev, dtype=torch.float64) - Mi.double() @ M64
    assert float(torch.linalg.matrix_norm(E, ord=2).max()) < 0.5
    cpu = kkt.cholesky_init(qp.to("cpu"), rho.cpu(), 1e-4, st)["M_inv"]
    Ec = torch.eye(N, dtype=torch.float64) - cpu.double() @ M64.cpu()
    assert float(torch.linalg.matrix_norm(Ec, ord=2).max()) < 0.5


def test_spans_add_no_device_event(dev, monkeypatch):
    """A traced fused ADMM solve (the benchmark's stack at B=8, n=256): the
    ``qps.*`` spans are host events only. No device event carries a
    ``qps.`` name, and the device events are the same set of names as in
    the same trace with every span switched off."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from quadraticprogramsolver_tpu_torch.core import lockstep
    from quadraticprogramsolver_tpu_torch.models import admm
    from quadraticprogramsolver_tpu_torch.utils import profiling

    qp, _ = _fleet(dev)
    st = pt.Settings(rho=0.4, adaptive_rho=False, check_interval=11,
                     kkt_refinement_steps=0, sigma_free_rhs=True,
                     fused_factor=True, fused_chunk=True, require_fused=True)

    def traced():
        """(device event names, span names) of one solve, traced after a
        warm-up step, 50 ms of host time kept from each edge."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            pt.solve(qp, st)
            torch.cuda.synchronize()
            prof.step()
            time.sleep(0.05)
            pt.solve(qp, st)
            torch.cuda.synchronize()
            time.sleep(0.05)
        ev = prof.events()
        return ({e.key for e in ev if e.device_type == DeviceType.CUDA
                 and not e.key.startswith("ProfilerStep")},
                {e.key for e in ev if e.key.startswith("qps.")})

    pt.solve(qp, st)
    on_device, spans = traced()
    assert {"qps.solve", "qps.factor", "qps.chunk", "qps.check",
            "qps.sync"} <= spans
    assert not [k for k in on_device if "qps." in k]
    for mod in (admm, lockstep):
        monkeypatch.setattr(mod, "span", lambda *a, **k: profiling._OFF)
    off_device, off_spans = traced()
    assert not off_spans
    assert on_device == off_device
