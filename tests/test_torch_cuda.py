"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card (sm_90a) and nvcc; elsewhere they skip. On a
machine with a card but without jax, run them without the repo's conftest
(which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

import quadraticprogramsolver_tpu_torch as pt
from quadraticprogramsolver_tpu_torch.ops import fused_admm, fused_factor, spd_kernels
from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
    device_random_qp_fleet)

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
    out = fused_admm.fused_admm_chunk(*args, K=7, alpha=1.6)
    ref = fused_admm.fused_admm_chunk_plain(*args, K=7, alpha=1.6)
    for o, r in zip(out, ref):
        assert _close(o, r)
    assert torch.equal(out[0][~active], x[~active])
    assert torch.equal(out[4][~active], z[~active])


def test_solve_runs_every_kernel(dev):
    qp, _ = _fleet(dev, 2, b=8, n=200, m=100)
    st = pt.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4, rho=0.4,
                     check_interval=11, kkt_refinement_steps=0,
                     sigma_free_rhs=True, fused_factor=True, fused_chunk=True,
                     require_fused=True)
    fns = (fused_factor.build_slab, spd_kernels.spd_inverse_unrolled,
           fused_factor.slab_level, fused_admm.fused_admm_chunk)
    for f in fns:
        f.launches = 0
    sol = pt.solve(qp, st)
    assert all(f.launches > 0 for f in fns)
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
