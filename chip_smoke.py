#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ``ok`` line):

1. Environment: a CUDA card, TF32 off, the card's name and power limit
   (nvidia-smi), and the kernels built from ``quadraticprogramsolver_tpu_torch/
   csrc`` with the build time.
2. Each of the four kernels against its plain PyTorch version on the card,
   at the main path's shapes (n=512, m=256, 512 lanes; the chunk with K=11
   and every fourth lane inactive), with the stated limit and both times
   (CUDA events, median of 5).
3. The main path: a seeded B=4096, n=512, m=256 random_qp fleet generated on
   the card, solved with the headline knobs (fused factor + fused chunk,
   sigma-free, require_fused) at static and at adaptive rho. Every lane must
   end with status 2 or 3, and every kernel's launch count must move.
4. Audit: 16 lanes (8 spread, 8 with the most iterations) re-solved in f64
   on the host by the JAX package's numpy/scipy oracle
   (quadraticprogramsolver_tpu/utils/oracle.py, loaded by path, which needs
   no jax); max |x - x_ref|_inf must be <= 1e-4.
5. The literal n=500, m=250, B=4096 shape through the solver's auto-pad,
   audited on the unpadded problem.

The last lines are the kernels JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "quadraticprogramsolver_tpu_torch"
ORACLE = os.path.join(HERE, "quadraticprogramsolver_tpu", "utils", "oracle.py")
SEED = 1234
DEVICE = "cuda"
N, M, B_MAIN = 512, 256, 4096
B_KERNEL, K_CHUNK = 512, 11
AUDIT_TARGET = 1e-4
#: Kernel-vs-plain limit on max|kernel - plain| / max(max|plain|, 1). Both
#: sides are FP32 with the same operation order per element except for sum
#: order and FMA contraction; the pivot blocks of this family are
#: well-conditioned (cond ~ 10-100), so differences stay at a few f32 ulps
#: times the reduction depth (<= 512): 1e-5 as in tests/test_fused_admm.py.
LIMIT = 1e-5

KERNELS = {
    "slab_build": ("csrc/slab_build.cu",
                   "quadraticprogramsolver_tpu/ops/fused_factor.py:80"),
    "pivot_sweep_v3": ("csrc/pivot_sweep.cu",
                       "quadraticprogramsolver_tpu/ops/spd_kernels.py:265"),
    "slab_level": ("csrc/slab_level.cu",
                   "quadraticprogramsolver_tpu/ops/fused_factor.py:131"),
    "admm_chunk": ("csrc/admm_chunk.cu",
                   "quadraticprogramsolver_tpu/ops/fused_admm.py:47"),
}


def log(*a):
    print(*a, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5, setup=None):
    """Median ms of fn() over reps, CUDA events around each call."""
    import torch

    times = []
    for _ in range(reps + 1):  # first call is a warm-up
        args = setup() if setup else ()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times[1:])


def compare(name, kern, plain, failures):
    """max|kernel - plain| over matching outputs; a breach of LIMIT is
    appended to ``failures`` (checked once every kernel has been compared)."""
    import torch

    if isinstance(kern, torch.Tensor):
        kern, plain = (kern,), (plain,)
    err = max(float((k - p).abs().max()) for k, p in zip(kern, plain))
    scale = max(max(float(p.abs().max()) for p in plain), 1.0)
    rel = err / scale
    finite = all(bool(torch.isfinite(k).all()) for k in kern)
    log(f"[phase 2] {name}: max abs err {err:.3e}, relative {rel:.3e} "
        f"(limit {LIMIT:.0e}), finite={finite}")
    if not (finite and rel <= LIMIT):
        failures.append(f"{name}: kernel disagrees with its plain version "
                        f"(relative {rel:.3e} > {LIMIT:.0e}, finite={finite})")
    return err


def phase_kernels(torch):
    from quadraticprogramsolver_tpu_torch.ops import fused_admm, fused_factor, spd_kernels
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    qp = device_random_qp_fleet(B_KERNEL, N, M, generator=g)
    rho_row = torch.full((B_KERNEL, M), 0.4, device=DEVICE)
    sigma = 1e-6
    kp = fused_factor.slab_k(M)
    out, failures = {}, []

    args = (qp.P, qp.A, qp.q, rho_row, sigma)
    Sk = fused_factor.build_slab(*args)
    Sp = fused_factor.build_slab_plain(*args)
    out["slab_build"] = (compare("slab_build", Sk, Sp, failures),
                         cuda_ms(lambda: fused_factor.build_slab(*args)),
                         cuda_ms(lambda: fused_factor.build_slab_plain(*args)))
    del Sk

    j = N // 128 - 1
    w_out = kp + j * 128
    D = Sp[:, j * 128:(j + 1) * 128, w_out:w_out + 128]
    Dk = spd_kernels.spd_inverse_unrolled(D)
    Dp = spd_kernels.pivot_sweep_v3_plain(D)
    out["pivot_sweep_v3"] = (
        compare("pivot_sweep_v3", Dk, Dp, failures),
        cuda_ms(lambda: spd_kernels.spd_inverse_unrolled(D)),
        cuda_ms(lambda: spd_kernels.pivot_sweep_v3_plain(D)))

    S1, S2 = Sp.clone(), Sp.clone()
    fused_factor.slab_level(S1, Dp, j, w_out)
    fused_factor.slab_level_plain(S2, Dp, j, w_out)
    err = compare("slab_level", S1[:, :, :w_out], S2[:, :, :w_out], failures)
    if not torch.equal(S1[:, :, w_out:], Sp[:, :, w_out:]):
        failures.append("slab_level wrote outside the live region")
    if torch.equal(S1[:, :, :w_out], Sp[:, :, :w_out]):
        failures.append("slab_level left the live region unchanged")
    del S1, S2
    scratch = torch.empty((B_KERNEL, 128, w_out), device=DEVICE)
    clone = lambda: (Sp.clone(),)  # noqa: E731 — a fresh slab per timed call
    out["slab_level"] = (
        err,
        cuda_ms(lambda S: fused_factor.slab_level(S, Dp, j, w_out, scratch),
                setup=clone),
        cuda_ms(lambda S: fused_factor.slab_level_plain(S, Dp, j, w_out),
                setup=clone))
    del Sp, D, Dk, Dp, scratch

    S = fused_factor.fused_factor_solve(qp.P, qp.A, qp.q, rho_row, sigma=sigma)
    G, gv = S[..., :M].contiguous(), S[..., M].contiguous()
    del S
    x = torch.randn((B_KERNEL, N), generator=g, device=DEVICE)
    z = torch.randn((B_KERNEL, M), generator=g, device=DEVICE)
    y = torch.randn((B_KERNEL, M), generator=g, device=DEVICE)
    active = torch.arange(B_KERNEL, device=DEVICE) % 4 != 3
    cargs = (G, qp.A, gv, qp.l, qp.u, x, z, y, rho_row, active)
    kw = dict(K=K_CHUNK, alpha=1.6)
    ck = fused_admm.fused_admm_chunk(*cargs, **kw)
    cp = fused_admm.fused_admm_chunk_plain(*cargs, **kw)
    err = compare("admm_chunk", ck, cp, failures)
    frozen = ~active
    if not (torch.equal(ck[0][frozen], x[frozen])
            and torch.equal(ck[3][frozen], x[frozen])
            and torch.equal(ck[4][frozen], z[frozen])):
        failures.append("admm_chunk: a frozen lane did not pass through")
    out["admm_chunk"] = (err,
                         cuda_ms(lambda: fused_admm.fused_admm_chunk(*cargs, **kw)),
                         cuda_ms(lambda: fused_admm.fused_admm_chunk_plain(*cargs, **kw)))
    for name, (e, ms, pms) in out.items():
        log(f"[phase 2] {name}: kernel {ms:.4f} ms, plain {pms:.4f} ms "
            f"(B={B_KERNEL}, n={N}, m={M}, median of 5)")
    require(not failures, "; ".join(failures))
    return out


def counters():
    from quadraticprogramsolver_tpu_torch.ops import fused_admm, fused_factor, spd_kernels

    return {"slab_build": fused_factor.build_slab,
            "pivot_sweep_v3": spd_kernels.spd_inverse_unrolled,
            "slab_level": fused_factor.slab_level,
            "admm_chunk": fused_admm.fused_admm_chunk}


def load_oracle():
    spec = importlib.util.spec_from_file_location("qps_f64_oracle", ORACLE)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def audit(qp, x, status, iters, label):
    """Max |x - x_ref|_inf over 8 spread + 8 most-iteration converged lanes."""
    import numpy as np

    oracle = load_oracle()
    conv = np.where((status == 2) | (status == 3))[0]
    spread = conv[:: max(1, len(conv) // 8)][:8]
    worst = conv[np.argsort(iters[conv], kind="stable")[-8:]]
    idx = sorted(set(spread.tolist()) | set(worst.tolist()))
    devs = []
    for i in idx:
        P, q, A, l, u = (t[i].double().cpu().numpy() for t in qp.tensors())
        ref = oracle.solve_qp_reference(P, q, A, l, u, eps_abs=1e-6,
                                        eps_rel=1e-6, rho=0.1,
                                        max_iterations=20000, linsys="splu")
        require(ref.status == 3, f"{label}: oracle did not converge on lane {i}")
        devs.append(float(np.abs(x[i] - ref.x).max()))
    worst_dev = max(devs)
    log(f"[phase 4] {label}: audit max|x - x_ref|_inf over {len(devs)} lanes "
        f"= {worst_dev:.3e} (target {AUDIT_TARGET:.0e})")
    require(worst_dev <= AUDIT_TARGET, f"{label}: audit {worst_dev:.3e} > "
            f"{AUDIT_TARGET:.0e}")
    return worst_dev


def run_main(torch, pkg, qp, settings):
    """Warm solve, then best of 3; returns (solution, best seconds)."""
    sol = pkg.solve(qp, settings)
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        sol = pkg.solve(qp, settings)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return sol, best


def factor_seconds(torch, qp, settings):
    from quadraticprogramsolver_tpu_torch.models import kkt

    rho = torch.full(qp.batch_shape, settings.rho, device=qp.device)
    best = None
    for _ in range(4):
        t0 = time.perf_counter()
        cache = kkt.cholesky_init(qp, rho, settings.sigma_for(qp.dtype), settings)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        del cache
        best = dt if best is None else min(best, dt)
    return best


def report_solve(qp, sol, dt, fdt, label):
    import numpy as np

    status = sol.info.status.cpu().numpy()
    iters = sol.info.iterations.cpu().numpy()
    x = sol.x.double().cpu().numpy()
    B = status.size
    solved = int(((status == 2) | (status == 3)).sum())
    log(f"[{label}] B={B}: solve {dt * 1e3:.2f} ms (best of 3), solved "
        f"{solved}/{B}, {solved / dt:.1f} solves/s, factor "
        f"{fdt * 1e3:.2f} ms, iterate {(dt - fdt) * 1e3:.2f} ms, iterations "
        f"p50 {np.median(iters):.0f} max {iters.max()}, statuses "
        f"{ {int(k): int(v) for k, v in zip(*np.unique(status, return_counts=True))} }")
    require(bool(np.isfinite(x).all()) and x.shape == (B, qp.n),
            f"{label}: non-finite or misshapen x")
    require(solved == B, f"{label}: {B - solved} lanes did not end with "
            "status 2 or 3")
    return x, status, iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, PKG, "csrc")):
        print(f"chip_smoke: {PKG}/csrc not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import quadraticprogramsolver_tpu_torch as pkg
    from quadraticprogramsolver_tpu_torch import _build
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)

    # Phase 1: environment and build.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log(f"[phase 1] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    lib = _build.load()
    log(f"[phase 1] kernels built in {lib.build_seconds:.1f} s -> "
        f"{os.path.relpath(lib.path, HERE)}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[phase 1]   {line.strip()}")

    # Phase 2: every kernel against its plain version.
    kstats = phase_kernels(torch)
    base = dict(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4, rho=0.4,
                check_interval=11, kkt_refinement_steps=0,
                sigma_free_rhs=True, fused_factor=True, fused_chunk=True,
                require_fused=True)
    static = pkg.Settings(adaptive_rho=False, **base)
    adaptive = pkg.Settings(adaptive_rho=True, **base)

    # Phase 3: the main path.
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    qp = device_random_qp_fleet(B_MAIN, N, M, generator=g)
    torch.cuda.synchronize()
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    sol = pkg.solve(qp, static)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in cnt.items()}
    log(f"[phase 3] kernel launches in one main-path solve: {launches}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    del sol
    for settings, label in ((static, "phase 3 static rho"),
                            (adaptive, "phase 3 adaptive rho")):
        sol, dt = run_main(torch, pkg, qp, settings)
        fdt = factor_seconds(torch, qp, settings)
        x, status, iters = report_solve(qp, sol, dt, fdt, label)
        del sol
        # Phase 4: the audit.
        audit(qp, x, status, iters, label)
    del qp

    # Phase 5: the literal 500/250 shape through the auto-pad.
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    qp = device_random_qp_fleet(B_MAIN, 500, 250, generator=g)
    p = pkg.plan(qp, static)
    require(p.padded == (512, 256), f"500/250 plan did not pad: {p}")
    sol, dt = run_main(torch, pkg, qp, static)
    fdt = factor_seconds(torch, pkg.pad_qp(qp, 512, 256), static)
    x, status, iters = report_solve(qp, sol, dt, fdt,
                                    "phase 5 500/250 static rho")
    del sol
    audit(qp, x, status, iters, "phase 5 500/250 static rho")
    del qp

    kernels = [{"name": name, "route": "cuda",
                "source": f"{PKG}/{src}", "replaces": rep,
                "launches": launches[name], "max_abs_err": kstats[name][0],
                "ms": kstats[name][1], "plain_ms": kstats[name][2]}
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
