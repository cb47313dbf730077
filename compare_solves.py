#!/usr/bin/env python3
"""Time chip_smoke.py's phase 3 and phase 6 static solves (or, with
``--minv``, its phase 7b and 7c solves) with the port found under ROOT, so
that two checkouts can be compared on one card in turns.

    git archive <parent> | tar -x -C _archive/parent   # a git-ignored directory
    for r in _archive/parent . . _archive/parent; do python3 compare_solves.py $r; done
    for r in _archive/parent . . _archive/parent; do python3 compare_solves.py $r --minv; done
    for r in _archive/parent . . _archive/parent; do python3 compare_solves.py $r --stacks; done
    for r in _archive/parent . . _archive/parent; do python3 compare_solves.py $r --ref; done
    for r in _archive/parent . . _archive/parent; do python3 compare_solves.py $r --knobs; done
    for r in _archive/parent . . _archive/parent; do python3 compare_solves.py $r --schur; done

Each run builds ROOT's kernels, generates phase 3's fleet (B=4096, n=512,
m=256, seed 1234, the sigma-free fused FP32 knobs at static rho 0.4, eps
1e-4) and phase 6's (B=4096, n=512, me = mi = 128, seed 1236, static rho
0.0125, eps 5e-5) on the card, and prints one JSON line: each solve's best
of 3 after a warm call, its factor timed alone (best of 4) and the peak
device memory of the warm call. ``--minv`` takes phase 7b's fleet (B=2048,
512/256, seed 1234, default Settings with the fused M^{-1} chunk, eps 1e-4)
and 7c's (B=2048, 512/128/128, seed 1236, rho0 0.1 adaptive, refinement
1, check_interval 50, eps 2e-5, where its audit passes) instead, each also
profiled once after a warm-up step: the M^{-1} chunk kernels' device
time, every kernel's device time and the chunk's launches. ``--stacks``
takes chip_smoke.py's phase-8 stacks instead, each at the eps where its
audit passes: 8a-8c bench.py's ``slab_settings``, ``slab_hi`` and the split
stack on phase 3's fleet, 8d ``slab_settings`` on the 500/250 fleet (seed
1234), 8e the ``proxqp_fleet.py --headline`` stack on phase 6's fleet (eps
5e-5), 8f and 8g phase 7b's and 7c's stacks at ``chunk_lanes=2``; each
solve's best of 3 after a warm call and its peak device memory. ``--ref``
takes phase 9a instead: phase 3's fleet and knobs with
``pivot_variant="ref"`` (eps 1e-4, where its audit passes), the solve and
its factor timed as phase 3's, with the statuses and iterations counted and
a SHA-256 of x's bytes, so that two checkouts' solves can be held bit for
bit. ``--knobs`` does the same for phases 9c-9g: phase 3's fleet and knobs
with ``pivot_variant`` "r2", "r4", "r8", "panel", then
``factor_precision="high"`` (each at eps 1e-4, where its audit passes).
``--schur`` takes chip_smoke.py's phase 10a blocks instead (B=3072
Dm'Dm/128 + 0.05 I, Dm from seed 1239) and times ``spd_inverse_128_schur``
on them and on their first 512: the call's best of 3 (host clock, ending in
a sync), its device time (chip_smoke.py's ``device_ms``: CUDA events around
20 calls queued behind a busy-wait kernel, each on its own copy of the
blocks from ``l2_copies``, so read from memory) and the paired sweep's
alone on the leading 64-blocks, with a SHA-256 of the inverse's bytes.
Needs a CUDA card.
"""

import hashlib

import json
import os
import sys
import time

from chip_smoke import device_ms, event_ms, l2_copies, on_device, traced


def best_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        best = dt if best is None else min(best, dt)
    return best


def chunk_profile(torch, fn):
    """(device ms of the M^{-1} chunk kernels, their launches, device ms of
    every kernel) in one solve traced by chip_smoke.py's ``traced`` (after a
    warm-up step, away from the active step's edges)."""
    prof, _ = traced(torch, fn)
    chunk = total = 0.0
    launches = 0
    for e in prof.key_averages():
        if not on_device(e):
            continue
        ms = event_ms(e)
        total += ms
        if "chunk_minv" in e.key:
            chunk += ms
            launches += e.count
    return chunk, launches, total


def schur(torch, out):
    """The Schur inverse on phase 10a's blocks, at B=3072 and its first 512;
    device times on copies of the blocks (from memory, not the L2)."""
    from quadraticprogramsolver_tpu_torch.ops import spd_kernels as sk

    g = torch.Generator(device="cuda").manual_seed(1239)
    Dm = torch.randn((3072, 128, 128), generator=g, device="cuda")
    D = Dm.transpose(1, 2) @ Dm / 128 + 0.05 * torch.eye(128, device="cuda")
    del Dm
    for b in (3072, 512):
        Db = D[:b]
        call = lambda: sk.spd_inverse_128_schur(Db)  # noqa: E731
        out[f"schur_b{b}_ms"] = best_ms(torch, call, 3)
        copies = l2_copies(Db)
        out[f"schur_b{b}_device_ms"] = device_ms(
            [lambda c=c: sk.spd_inverse_128_schur(c[0]) for c in copies])
        out[f"paired_sweep_b{b}_device_ms"] = device_ms(
            [lambda c=c: sk.spd_inverse_64p(c[0][:, :64, :64]) for c in copies])
        del copies
        out[f"schur_b{b}_sha256"] = hashlib.sha256(
            call().cpu().numpy().tobytes()).hexdigest()


def stacks(torch, pkg, run):
    """The phase-8 stacks through ``run(tag, solve)``."""
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)
    from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
        device_prox_fleet)

    base = dict(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4, rho=0.4,
                check_interval=11, kkt_refinement_steps=0, sigma_free_rhs=True,
                fused_factor=True, fused_chunk=True, require_fused=True,
                adaptive_rho=False)
    slab = dict(slab_cache=True, chunk_lanes=2, chunk_dot_precision="high",
                first_chunk_dot_precision="default")
    knobs = {"8a": slab,
             "8b": dict(slab_cache=True, chunk_lanes=4,
                        first_chunk_dot_precision="default"),
             "8c": dict(split_cache=True, chunk_lanes=2, chunk_dot_precision="high"),
             "8d": slab}
    for n, m, tags in ((512, 256, ("8a", "8b", "8c")), (500, 250, ("8d",))):
        g = torch.Generator(device="cuda").manual_seed(1234)
        qp = device_random_qp_fleet(4096, n, m, generator=g)
        for tag in tags:
            st = pkg.Settings(**base, **knobs[tag])
            run(tag, lambda: pkg.solve(qp, st))
        del qp
    g = torch.Generator(device="cuda").manual_seed(1236)
    prob = device_prox_fleet(4096, 512, 128, 128, generator=g)
    ps = pkg.ProxQPSettings(max_iterations=2000, eps_abs=5e-5, eps_rel=5e-5,
                            rho=0.0125, adaptive_rho=False, check_interval=25,
                            kkt_warm_start=False, kkt_refinement_steps=0,
                            sigma_free_rhs=True, fused_chunk=True, chunk_lanes=2,
                            chunk_dot_precision="high",
                            first_chunk_dot_precision="default", require_fused=True)
    run("8e", lambda: pkg.solve_proxqp(prob, ps))
    del prob
    g = torch.Generator(device="cuda").manual_seed(1234)
    qp = device_random_qp_fleet(2048, 512, 256, generator=g)
    st = pkg.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4,
                      fused_chunk=True, require_fused=True, chunk_lanes=2)
    run("8f", lambda: pkg.solve(qp, st))
    del qp
    g = torch.Generator(device="cuda").manual_seed(1236)
    prob = device_prox_fleet(2048, 512, 128, 128, generator=g)
    ps = pkg.ProxQPSettings(max_iterations=2000, eps_abs=2e-5, eps_rel=2e-5,
                            rho=0.1, adaptive_rho=True, kkt_refinement_steps=1,
                            check_interval=50, kkt_warm_start=False,
                            fused_chunk=True, require_fused=True, chunk_lanes=2)
    run("8g", lambda: pkg.solve_proxqp(prob, ps))


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = os.path.abspath(args[0] if args else ".")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("compare_solves: no CUDA device", file=sys.stderr)
        return 2
    import quadraticprogramsolver_tpu_torch as pkg
    from quadraticprogramsolver_tpu_torch.models import kkt, proxqp
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)
    from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
        device_prox_fleet)

    if not pkg.__file__.startswith(root):
        raise RuntimeError(f"imported {pkg.__file__}, not the port under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": args[0] if args else ".",
           "device": torch.cuda.get_device_name(0)}

    def run(tag, solve, factor=None, profile=False):
        torch.cuda.reset_peak_memory_stats()
        solve()
        torch.cuda.synchronize()
        out[f"{tag}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[f"{tag}_solve_ms"] = best_ms(torch, solve, 3)
        if profile:
            (out[f"{tag}_chunk_ms"], out[f"{tag}_chunk_launches"],
             out[f"{tag}_device_ms"]) = chunk_profile(torch, solve)
        if factor is not None:
            out[f"{tag}_factor_ms"] = best_ms(torch, factor, 4)

    knobs = ({"9a": dict(pivot_variant="ref")} if "--ref" in sys.argv[1:]
             else {"9c": dict(pivot_variant="r2"), "9d": dict(pivot_variant="r4"),
                   "9e": dict(pivot_variant="r8"),
                   "9f": dict(pivot_variant="panel"),
                   "9g": dict(factor_precision="high")}
             if "--knobs" in sys.argv[1:] else {})
    if knobs:
        g = torch.Generator(device="cuda").manual_seed(1234)
        qp = device_random_qp_fleet(4096, 512, 256, generator=g)
        for tag, kw in knobs.items():
            st = pkg.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4,
                              rho=0.4, check_interval=11,
                              kkt_refinement_steps=0, sigma_free_rhs=True,
                              fused_factor=True, fused_chunk=True,
                              require_fused=True, adaptive_rho=False, **kw)
            rho = torch.full(qp.batch_shape, st.rho, device="cuda")
            run(f"phase{tag}", lambda: pkg.solve(qp, st),
                lambda: kkt.cholesky_init(qp, rho, st.sigma_for(qp.dtype), st))
            sol = pkg.solve(qp, st)
            its = sol.info.iterations
            out[f"phase{tag}_status"] = {int(k): int(v) for k, v in zip(
                *torch.unique(sol.info.status, return_counts=True))}
            out[f"phase{tag}_iterations_p50_max"] = [int(its.float().median()),
                                                     int(its.max())]
            out[f"phase{tag}_x_sha256"] = hashlib.sha256(
                sol.x.cpu().numpy().tobytes()).hexdigest()
            del sol
        print(json.dumps(out), flush=True)
        return 0
    if "--schur" in sys.argv[1:]:
        schur(torch, out)
        print(json.dumps(out), flush=True)
        return 0
    if "--stacks" in sys.argv[1:]:
        stacks(torch, pkg, run)
        print(json.dumps(out), flush=True)
        return 0
    if "--minv" in sys.argv[1:]:
        g = torch.Generator(device="cuda").manual_seed(1234)
        qp = device_random_qp_fleet(2048, 512, 256, generator=g)
        st = pkg.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4,
                          fused_chunk=True, require_fused=True)
        run("phase7b", lambda: pkg.solve(qp, st), profile=True)
        del qp
        g = torch.Generator(device="cuda").manual_seed(1236)
        prob = device_prox_fleet(2048, 512, 128, 128, generator=g)
        ps = pkg.ProxQPSettings(max_iterations=2000, eps_abs=2e-5, eps_rel=2e-5,
                                rho=0.1, adaptive_rho=True, kkt_refinement_steps=1,
                                check_interval=50, kkt_warm_start=False,
                                fused_chunk=True, require_fused=True)
        run("phase7c", lambda: pkg.solve_proxqp(prob, ps), profile=True)
        print(json.dumps(out), flush=True)
        return 0
    g = torch.Generator(device="cuda").manual_seed(1234)
    qp = device_random_qp_fleet(4096, 512, 256, generator=g)
    st = pkg.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4, rho=0.4,
                      check_interval=11, kkt_refinement_steps=0,
                      sigma_free_rhs=True, fused_factor=True, fused_chunk=True,
                      require_fused=True, adaptive_rho=False)
    rho = torch.full(qp.batch_shape, st.rho, device="cuda")
    run("phase3", lambda: pkg.solve(qp, st),
        lambda: kkt.cholesky_init(qp, rho, st.sigma_for(qp.dtype), st))
    del qp
    g = torch.Generator(device="cuda").manual_seed(1236)
    prob = device_prox_fleet(4096, 512, 128, 128, generator=g)
    ps = pkg.ProxQPSettings(eps_abs=5e-5, eps_rel=5e-5, rho=0.0125,
                            adaptive_rho=False, max_iterations=2000,
                            check_interval=25, kkt_warm_start=False,
                            kkt_refinement_steps=0, sigma_free_rhs=True,
                            fused_chunk=True, require_fused=True)
    rho = torch.full(prob.batch_shape, ps.rho, device="cuda")
    run("phase6", lambda: pkg.solve_proxqp(prob, ps),
        lambda: proxqp._build_sigma_free_cache(prob, rho, ps))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
