#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ``ok`` line):

1. Environment: a CUDA card, TF32 off, the card's name and power limit
   (nvidia-smi), and the kernels built from ``quadraticprogramsolver_tpu_torch/
   csrc`` with the build time.
2. Each of the seven kernels against its plain PyTorch version on the card,
   at the main paths' shapes (n=512, m=256, 512 lanes; the ADMM chunk with
   K=11 and every fourth lane inactive; the slab build again with two row
   blocks me = mi = 128, and the prox chunk at n=512, me = mi = 128, K=25,
   every fourth lane inactive; the two M^{-1}-form chunks at K=25 with one
   refinement pass, every fourth lane inactive), with the stated limit,
   both times (CUDA events, median of 5), the time of one PyTorch call that
   computes the same function where there is one, and the kernel's bound:
   the larger of its bytes (each input read once, each output written once)
   over 3.35 TB/s and its FLOPs (FP32 ones over 67 TFLOP/s, products of two
   bf16 operands summed in FP32 over the 989 TFLOP/s of the bf16 tensor
   cores), the H100 SXM's published peaks. The two M^{-1} chunks are also held, output by output,
   against their plain version run in f64 (the witness: the kernel's error
   within 3x the FP32 plain version's; the cluster kernels), the prox one
   at phase 6's penalties and at phase 7c's rho0 = 0.1. Rows 1, 2, 3, 4a,
   4b, 5a and 5b's kernels run beside
   the previous kernels they replace on the main paths, kept as their
   witnesses (``slab_build_prev``, ``slab_level_prev``,
   ``pivot_sweep_v3_prev``; ``admm_chunk`` and ``prox_chunk``, the
   streaming chunks that every other variant runs): the triangle build
   (``slab_build``, one launch over the gram's upper triangle) bit for bit
   the previous kernels on [A' | q | 0] and M's upper triangle, its gram part
   exactly symmetric and within MIRROR_TOL of theirs, one and two row blocks;
   the strip level (``slab_level``, one launch a level, bf16x6 on the
   tensor cores) within X6_GATE of the previous two-launch FP32 level's
   error against a float64 run of the level, and no slower at B=512 than
   the SIMT strip kernel it replaced (SIMT_STRIP_MS); each timed in turns beside
   its bound and one ``torch.baddbmm`` (TF32 off) on its dominant product
   shapes, the card's FP32 rate as a yardstick; the v3 pivot sweep bit
   for bit its previous kernel on the slab's pivot blocks and on
   spread-diagonal blocks, the ADMM cluster chunk (``admm_chunk_cluster``)
   bit for bit the streaming one on all seven outputs from G and from the
   slab window at K=11 and K=1, the prox cluster chunk
   (``prox_chunk_cluster``) bit for bit the streaming one on x, s, y and z
   at K=25 and K=1, and the M^{-1}-form cluster chunks
   (``admm_chunk_minv_cluster``, ``prox_chunk_minv_cluster``, rows 4b and
   5b) bit for bit the streaming M^{-1} chunks (``admm_chunk_minv``,
   ``prox_chunk_minv``, their witnesses) on every output at K=25 and K=1,
   each pair timed in turns (old, new, new, old). Then each chunk variant of rows 4c/5c (an
   entry of its own in the kernels JSON), launched through the solver's
   dispatch, which must send it to a cluster kernel (its key ends in
   ",cluster": every variant's lane fits one): the sigma-free
   ADMM chunk at "high" and "default" (held by the f64 witness, whose plain
   version in f64 runs without rounding) and with the split G, the slab
   window, lanes 2 (all three at "high", bit for bit equal to the "high"
   kernel) and lanes 4 (FP32, bit for bit the lanes-1 kernel); the M^{-1}
   ADMM chunk at lanes 2; the prox chunk at "high", "default" and lanes 2;
   the M^{-1} prox chunk at lanes 2. Each is also bit for bit the streaming
   kernel of the same variant (its witness) and timed in turns beside it.
   The bound of "high" counts its iterate products three times. The witness cannot fail a "default" kernel that skips a rounding
   (the plain "default" lies far from f64), so each family's "default"
   kernel is also held at K=1 against its plain version and its own
   "highest" (``default_check``). Then rows 7-10 and 3b, the fused
   factor's knobs: each pivot formulation ("ref", "value", "r2", "r4",
   "r8", "panel") on the slab's pivot blocks and on spread-diagonal blocks,
   against its plain version (LIMIT; "ref", which has no Jacobi scaling, by
   the f64 witness where FP32 rounding alone fills LIMIT; "value" bit for
   bit against v3, whose arithmetic it is), timed on the slab's blocks
   beside ``torch.linalg.inv``; the rank-q and panel sweeps (rows 9 and 10,
   v3's register layout) also bit for bit their first port
   (``pivot_sweep_group_prev``) and timed in turns beside it; and the
   bf16x3 slab level ("high", row 3b, one strip launch a level on the
   tensor cores) at j=3 against its plain version (LIMIT), apart from its
   own FP32 level on the pivot rows (HIGH_GAP) and bit for bit the
   two-launch bf16x3 level (``slab_level_prev`` at "high"), timed in turns
   beside it. Then rows 6, 11 and 12, the package's other
   SPD-inverse entry points (``phase_entry_kernels``): the round-1 unscaled
   sweep on the slab's pivot blocks and spread-diagonal blocks, the
   paired-64 sweep on their leading 64-blocks (LIMIT, or the f64 witness
   where FP32 rounding fills it; beside ``torch.linalg.inv``), the Schur
   inverse of the 128-blocks (its time split by launch kind, beside row
   2's direct v3 sweep: ``schur_split``), and the fused normal-matrix
   inverse of the phase's n=512, m=256 fleet with per-lane rho (beside the
   library Cholesky inverse of a torch-built M and the port's M^{-1}
   route). Rows 6, 7, 11 and 12's kernels (the unscaled sweep in v3's
   register layout, the paired sweep in v3's layout on its side, the normal
   inverse in place on sgemm.cuh) are also held bit for bit against their
   first ports, kept as witnesses (``pivot_sweep_2d_prev`` also under its
   zero-pivot guard, ``pivot_sweep_ref_prev``, ``pivot_sweep_v3p_prev``,
   ``normal_inverse_prev``), and timed in turns beside them (row 11 on the
   device alone, ``device_ms``).
2b. Rows 1, 2, 3, 4a and 5a at the main paths' B=4096 beside their previous
   kernels (the build of both families and the level at j=3 as in phase 2,
   with the yardstick; the pivot sweep on the fleet's last pivot blocks,
   and rows 6 and 7 on the same blocks beside their witnesses; rows 3b, 9
   and 10 beside theirs at B=512 and 4096 (``knob_redesigns``), row 11
   beside its witness on slab, spread and gram 64-blocks at B=512, 3072 and
   4096 (``paired_redesign``) and the Schur inverse's time split on phase
   10a's 128-blocks at B=3072, the ADMM chunk
   at K=11 and the prox chunk at K=25 with every lane active, also at
   B=512), bit for bit and timed in turns, with each cluster chunk's
   clusters resident at once; rows 4c and 5c, each "high" and "default"
   cluster variant (ADMM from G, the bf16 halves and the slab window; prox)
   beside the streaming kernel of the same variant, bit for bit, in turns,
   beside its bound and the "highest" cluster kernel (``variant_pairs``);
   and rows 4b and 5b, the M^{-1}-form cluster
   chunks beside the streaming ones at K=25, refine 1, every lane active,
   at B=512 and at phase 7's B=2048 (``minv_redesigns``).
3. The main path: a seeded B=4096, n=512, m=256 random_qp fleet generated on
   the card, solved with the headline knobs (fused factor + fused chunk,
   sigma-free, require_fused) at static and at adaptive rho. Every lane must
   end with status 2 or 3, every kernel's launch count must move, the
   factor must run one triangle build and 4 strip levels (``factor_kernels``),
   and the chunk must run the kernel the dispatch rule names for its variant
   (``ops/fused_admm.py: chunk_kernel``: the cluster chunk). Peak memory of
   the counted solve.
4. Audit: 16 lanes (8 spread, 8 with the most iterations) re-solved in f64
   on the host by ``f64_oracle.py`` beside this script (numpy and scipy
   only); max |x - x_ref|_inf must be <= 1e-4.
5. The literal n=500, m=250, B=4096 shape through the solver's auto-pad,
   audited on the unpadded problem.
6. The prox-ALM family: a seeded B=4096, n=512, n_eq = n_ineq = 128
   split-form fleet (problems/prox_fleet.py) solved by ``solve_proxqp`` with
   the sigma-free fused knobs at static rho = 0.0125 and again at adaptive
   rho (rho0 = 0.1, which must refactor in the loop). Every lane must end
   with status 3, the slab, pivot, level and prox chunk kernels must all
   launch, the factor through the triangle build and the strip levels, the
   chunk through the kernel the dispatch rule names
   (``ops/fused_proxqp.py: chunk_kernel``: the cluster chunk), and 8 lanes (4 spread, the 4 other converged lanes with the most
   iterations) re-solved by the f64 oracle on the lowered box form must agree
   within 1e-4. Each run starts at eps 5e-5 and is repeated at 2e-5, then
   1e-5, while the audit fails; the eps used is printed.
7. The M^{-1} form (the default settings of both families), B=2048:
   7a. bench.py's ``defaults`` row: the random_qp 512/256 fleet (seed 1234)
       with ``Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4)``:
       the factor runs the blocked Gauss-Jordan sweep, 4 pivot launches per
       factor and no Cholesky, the torch chunk; 7b. the same with
       ``fused_chunk=True, require_fused=True``: one M^{-1} chunk launch per
       check, every one through the cluster kernel (``minv_cluster_only``:
       ``fused_admm_chunk_minv.variants`` key "lanes1,cluster"); 7c. the phase-6 prox fleet at B=2048 with the JAX package's
       M^{-1} fleet settings (benchmarks/proxqp_fleet.py: rho0 = 0.1
       adaptive, refinement 1, check_interval 50, zero start) and the fused
       M^{-1} prox chunk, every launch through the cluster kernel, which is
       then held against its f64 witness at the penalties that run ended
       with. Each starts at eps 1e-4 and tightens
       to 2e-5, then 1e-5, while its f64 audit (16 ADMM / 8 prox lanes)
       fails; each
       prints its solve, its factor timed alone beside
       ``torch.cholesky_inverse(torch.linalg.cholesky(M))`` on the same M,
       iterations, refactors and peak memory.

8. bench.py's tuned stacks, each with require_fused, static rho and the
   audit of its family (16 ADMM / 8 prox lanes), tightening eps while the
   audit fails; each prints its solve, factor, iterations, eps, audit, peak
   memory and the launches of every chunk variant, and fails if a variant of
   its stack never launched or a launch did not run a cluster kernel (its
   key must end in ",cluster"): 8a bench.py's ``slab_settings`` (slab window,
   lanes 2, "high", a "default" first chunk) on phase 3's fleet; 8b its
   ``slab_hi`` (slab window, lanes 4, FP32, the same schedule); 8c the
   ``split_cache`` stack (8a with the bf16 G halves, no schedule); 8d the
   literal 500/250 fleet under ``slab_settings`` (bench.py's
   ``baseline_shape`` row); 8e the ``benchmarks/proxqp_fleet.py --headline``
   stack on phase 6's fleet (lanes 2, "high", a "default" first chunk). 8f
   and 8g run phase 7b's and 7c's stacks at lanes 2 beside lanes 1 (the
   M^{-1} cluster chunks at both): the same statuses, iterations and x,
   bit for bit. Every stack (8f and 8g at lanes 2) is solved again with
   every chunk on its streaming kernel (``streaming_witness``, a context
   of this script that points the dispatch rules at "stream", its launches
   counted apart), timed, and must give the same statuses, iterations and
   x, bit for bit.
9. The fused factor's knobs on phase 3's fleet and static-rho stack, one at
   a time: 9a-9f ``pivot_variant`` = "ref", "value", "r2", "r4", "r8",
   "panel", 9g ``factor_precision="high"``. Each tightens eps while its
   16-lane audit fails, prints its solve (best of 3), factor (best of 4),
   iterations, eps, audit and peak memory, and fails unless every factor
   build launched its named pivot formulation and level precision 4 times
   each and nothing else (``spd_inverse_unrolled.variants``,
   ``slab_level.variants``; the group formulations through
   ``group_sweep_kernel``, "high" through the strip kernel) and no witness
   wrapper launched.

10. The SPD-inverse entry points at sizes users run: 10a the shootout of
    benchmarks/pivot_inverse_probe.py on its defaults (B=3072 blocks
    Dm'Dm/128 + 0.05 I): v3, "ref", "r2", "r4", "r8", "panel",
    ``spd_inverse_nb``, ``spd_inverse_128_schur``, ``torch.linalg.inv`` and
    the Cholesky inverse, each the best of 3 after a warm call with its
    error against f64 on three lanes (rows 6 and 11 must reach the probe's
    1e-5), then one counted Schur call (exactly 2 paired sweeps, no
    witness); 10b ``spd_inverse_sweep`` beside the same sweep on row 6's
    witness (bit for bit) and ``spd_inverse_sweep_fused`` on phase 7a's
    normal matrices (B=2048, n=512; 4 row-6 launches a call); 10c
    ``normal_inverse`` on phase 7a's P and A with one rho a lane (0.1,
    sigma 1e-6) beside its witness (bit for bit) and the M^{-1} route's
    build and sweep of the same M, with peak memory, held by the f64
    witness and against f64 on three lanes; the device kernels of one
    call and of one witness call as torch.profiler traces them (1 + 3 n/128
    each) with their device time by launch kind (gram, pivot, CD, strip;
    the witness's gram, pivot, products, update); 10d phase 7a's defaults
    solve on 64 lanes with
    ``allow_tf32 = True`` globally, whose x must equal the TF32-off x bit
    for bit (the solve scopes its products to FP32).
11. The large sparse path, BASELINE config 4 (``benchmarks/large_sparse.py``:
    n = 1e5, m = 5e4, seed 0, 10 host Ruiz sweeps, float32):
    11a the solve with ELL storage and the matrix-free CG backend at
    large_sparse.py's settings (eps 1e-4, rho 0.1 adaptive, cg_eps 1e-6,
    cg_rel_eps 1e-4, 300 iterations, check_interval 25) through
    ``solve(..., scaling=)``: a counted run, then the best of 3 after a warm
    call. It must end SOLVED, pass the OSQP criterion in f64 on the
    unscaled problem (``utils/oracle.py: kkt_optimality``; res_prim <= 1e-4
    + 1e-4 max(|Ax|, |z|), res_dual <= 1e-4 + 1e-4 max(|Px|, |A'y|, |q|)),
    and launch row 13's ELL kernel exactly as often as the host loop says
    (3 + 5 per outer iteration + 3 per CG step + 3 per check); it prints
    the CG steps and host syncs. 11b the same with CSR storage (cuSPARSE;
    no kernel of ours may launch). 11c row 13 alone on P, A and A' against
    its plain version and the kernel it replaced (``ell_matvec_prev``, its
    witness; both within LIMIT), timed in turns beside it, the plain version
    and the CSR product, each call on the next of several copies of the
    matrix that together overflow the L2 (``l2_copies``), so that the times
    read from device memory as the bound does (the times on one matrix,
    warm in the L2, are printed too); every SpMV time in phase 11 is device
    time (``device_ms``: CUDA events around 20 calls queued behind a
    busy-wait kernel), since CUDA events around calls of a few microseconds
    time the host's launches. Every counted run (phases 3 and 6-11) also
    requires that no witness wrapper (``WITNESS_WRAPPERS``: the previous
    kernels and the chunk wrappers that bypass the dispatch rule) launched;
    the kernels JSON reports their counts from the main path's runs (phase
    3, 6 or 11a). 11d rows 14a, 14b and 15 on P at
    n = 1e5 with the probes' defaults (route levels S = 8, W = 12544, and
    every micro shape of ``routed_spmv_probe.py:181-183``; the row-routed
    format) and on the 2-D Laplacian of a 316 x 316 grid (14b and 15):
    packers, occupied sectors and fill, kernels against their plain
    versions and their witnesses (the first ports: the route levels bit for
    bit ``routed_levels_prev`` with and without the occupancy mask; 14a,
    which runs the first port's kernel, beside the level-split kernel with
    a full mask at every micro shape, bit for bit; the 128-wide tile census
    of ``routed_spmv_probe.py:108-138``; the fused row-routed matvec within
    1e-6 of max|y| of
    the rows kernel summed by ``index_add_``, and the same bits on two
    calls), the whole matvecs against scipy in f64 (relative 1e-6) in one
    counted call each, device times from device memory and warm, bounds
    (occupied sectors, and the bytes the first ports streamed), CSR.

12. The rest of the ADMM core at the JAX package's user settings, f32:
    12a Ruiz scaling at ``benchmarks/sweep_classes.py``'s settings (eps
    1e-4, rho 0.1 adaptive, refinement 2, ``scaling_iters=10``, fused
    chunk) over the 9 classes at n=128 (the capped families at m=128),
    B=256 a class from the port's generator (seed 0), padded to (512, 384):
    per class solved/total, p50 and max iterations, solve ms (best of 3
    after a warm call), the audit of 4 spread and 4 straggling lanes on the
    unscaled problem (at eps 1e-6 where 1e-4 misses the target; a class
    f32 cannot bring there, x within 10x the target or the objective
    within it), and rows 2 and 4b launched (the streaming M^{-1} kernel
    there: the lane does not fit a cluster); then phase 3's fleet and
    sigma-free stack with ``scaling_iters=10`` (rows 1-4a on the scaled
    problem, audited unscaled). The audits' f64 solves run in 8 spawned
    worker processes. 12b Anderson at
    ``examples/anderson_acceleration.py``'s family and settings
    (INEQUALITY_QP n=100, m=1000, rho 0.1, check interval 25, 4000
    iterations) at B=1024, eps 1e-4, with the fused M^{-1} chunk (padded to
    128 x 1024), ``anderson_memory`` 0 beside 8 (p50, max and total
    iterations, the share of mixes accepted, solve ms, both audited, at
    eps 1e-5 where 1e-4 misses the target), the
    8-memory solve again with ``record_history`` ((num_checks, B), finite
    up to the last check run, inf after); then phase 6's prox shape and
    static stack at B=1024 the same way. 12c polish on phase 7a's fleet and
    settings with ``polish_iterations=3``: the share of lanes accepted, the
    p50 KKT error before and after, the audit, row 2's launches of the
    factor and of the polish (H at 512, S at 256) from the counters. 12d
    factor reuse at ``examples/mpc_fleet.py``'s headline ticks (H=512,
    B=2048, T=8, P and A shared by the fleet, q drifting 0.02 a tick, rho
    0.4 static, check interval 12, eps 1e-4, 1000 iterations): per-tick
    ``solve`` warm-started from the last tick (4 pivot launches a tick),
    ``CachedQPSolver`` (``update(q=)``, ``solve(warm_start=t > 0)``: no
    pivot launch after setup) and ``solve_sequence_vectors`` with reuse off
    and on, every tick status >= 2, each way's wall ms, the iterations a
    tick and the final tick's max |x_cached - x_naive|; then one prepared
    solve of phase 3's fleet at its sigma-free stack (statuses 2/3, the
    audit, the chunk kernel's launches). A ``paths`` JSON line gives each
    kernel's launches on 12a-12d.

13. The rest of the KKT layer and the matrix-free prox path, f32: 13a
    ``benchmarks/compare_kkt_backends.py``'s size sweep (RANDOM_QP, B=64,
    n in {64, 128, 256}, m = n/2, seed 1234, rho 0.1 adaptive, eps 1e-5,
    4000 iterations) through CHOLESKY and KKT_LDL, and at n=256 alone CG
    and KKT_MINRES: best of 3 ms (the counted run one; the Krylov
    backends' counted run alone), solved, p50 iterations, the factor
    functions' calls, Krylov steps and host syncs, row 2's launches (n/128
    a CHOLESKY build, n/128 a MINRES solve: its preconditioner), the factor
    alone (its init function, best of 3), every lane status 2/3, a 4 + 4
    lane audit tightening eps (1e-5, 2e-6, 1e-6) while it misses the
    target, and LDL's x within 1e-4 of CHOLESKY's; 13b the script's
    crossover (portfolio and huber with m 60 at B=4, n=256, at most 100
    outer iterations, CG against MINRES with cg_max_iterations 500, each
    timed by its counted run, with its ms and Krylov steps an outer
    iteration); 13c the MINRES polish on a tall
    INEQUALITY_QP fleet (n=64, m=640, B=256, polish_iterations 3: lanes
    accepted, at least half, p50 KKT error before and after, the audit
    reported) and on config 4 (accepted or not, the ELL launches inside
    the polish); 13d KKT_MINRES on config 4 beside CG, each SOLVED and
    passing the f64 OSQP criterion; 13e ``benchmarks/large_smoothing.py``
    --tpu's n = 5e4 problem as one SparseProxQP solve (ELL, anderson_memory
    8): x[0] within 1e-5 of its pin, the residuals recomputed in f64 on the
    host within 10 % of the reported ones, the largest step against the
    monotone direction within the primal residual (the benchmark's exact
    1e-6 check printed beside it), then tests/test_operators.py's n = 2000
    case in float64 on the card (CSR: row 13 takes float32): SOLVED,
    exactly monotone, within 1e-6 of the port's CPU f64 solve. Phase 13's
    launches of rows 2 and 13 join the ``paths`` line.

14. Reduced product precision (``matmul_precision``, ``factor_precision``)
    and the host utilities (``phase_precision``).

15. The distributed modes (parallel/): 15a this process as a one-rank NCCL
    world: ``solve_fleet`` on phase 3's fleet and stack and
    ``solve_prox_fleet`` on phase 6's, each bit for bit the single-card
    solve (x, y, z (s), statuses, iterations, residuals) with the same
    launches of rows 1-3 and 4a / 5a; ``solve_fleet_block_split`` on a
    (1, 1) mesh at B=64 (row 2 in its factor) against the single-card solve
    at the same settings (statuses and iterations identical, x within
    PARALLEL_X_TOL); the one-rank block splits of a 512/256 QP and a
    512/128/128 prox QP; config 4 as one shard (``solve_sparse_mesh``, row
    13 counted) held to 11a's status and f64 audit, with the iterations and
    max |x - x_11a| printed. 15b two gloo ranks on the one card, CUDA
    tensors (``rank_15b``, spawned after 15a's world is gone; gloo's
    all_reduce and all_gather on CUDA tensors checked first): the fleets as
    2 x 2048, the block splits 2 ways, config 4 at 2 shards, each held to
    its one-rank run (statuses and iterations identical, x within
    PARALLEL_X_TOL, PARALLEL_SPARSE_X_TOL for config 4, which also passes
    the f64 audit). 15c ``dryrun_multichip(2, device="cuda")`` over gloo.
    Each entry's ms per rank (best of 3) is printed beside the one-rank or
    single-card run's, with the ranks' device; the launches of the path
    kernels inside the entry points join the kernels line
    (``launches_by_path``). ``--parallel-only`` runs phases 1 and 15 alone.

16. The benchmark harness, the blocked-Schur inverse and the examples
    (``phase_harness``): 16a ``bench/harness.py: run_sweep`` over
    ``default_sweep()`` (9 classes x n in {20, 100}, B=64) at its default
    settings in f32 on the card, 3 samples, into a CSV and a JSONL in a
    temporary directory: every case returns, the sweep printed as one
    table (ms, solves/s, iterations/s, p50 iterations, solved/total), the
    CSV header ``CSV_COLUMNS``, the device column "gpu:" and the
    nvidia-smi line in every row, a second run appended and two headline
    records appended through the guards, a drifted CSV and a drifted
    headline record refused; the random_qp n=100 case re-solved and 16
    lanes audited against f64_oracle.py (the phase-4 ladder). 16b
    ``ops/linalg.py: spd_inverse_blocked`` beside ``cholesky_inverse`` and
    ``torch.linalg.inv`` at (2048, 500, 500) f32 and (256, 512, 512) f64:
    ms and the error against numpy f64 inverses of 3 lanes. 16c the six
    ``examples/*_torch.py`` on the card at their default sizes, each in
    its own process (all started together, each with its own timeout),
    every one exiting 0. ``--harness-only`` runs phases 1 and 16 alone.

``python3 chip_smoke.py --profile`` adds one profiled static-rho solve of
phase 3 (the ADMM headline), one profiled static-rho prox solve,
one profiled solve each of phases 7a, 7b and 7c, one each of 8a, 8e and 8f
(lanes 2), one of 9g and one of the fastest of 9c-9f, and one of phase 11a
(kernel time by name and the device's idle share; phases 3, 6, 9g and 9c-9f
must trace one ``slab_build_kernel`` and 4 ``level_strip_kernel``-family
launches and none of the previous factor kernels, 9g 4
``level_strip_kernel_high`` and 9c-9f 4 ``group_sweep_kernel``). ``--sparse-only`` runs phases 1 and 11 alone and
prints no ``ok`` line; ``--core-only`` runs phases 1 and 12 alone, the
same way, ``--kkt-only`` phases 1 and 13, ``--precision-only`` phases 1
and 14, ``--parallel-only`` phases 1 and 15 and ``--harness-only``
phases 1 and 16. ``--time-chunks`` adds,
after phase 2, the times of the sigma-free chunks and their variants at the
main path's B=4096 with every lane active (``time_chunks``).

The last lines are the total wall time, phases 12-16's ``paths`` JSON, the
kernels JSON (the seven kernels,
the four cluster chunks and the previous build, level and v3 kernels, the eleven variants of
rows 4c and 5c, the six pivot formulations and the bf16x3 level of rows
7-10 and 3b, the three kernels of rows 6, 11 and 12 and the first kernels
of rows 6, 7, 9-10 and 12, and the SpMV kernels of rows 13, 14a, 14b and 15 with
row 13's previous kernel), the nvidia-smi
line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "quadraticprogramsolver_tpu_torch"
SEED = 1234
DEVICE = "cuda"
N, M, B_MAIN = 512, 256, 4096
B_KERNEL, K_CHUNK = 512, 11
ME, MI, K_PROX = 128, 128, 25
B_DEFAULTS, K_MINV, REFINE = 2048, 25, 1
LEVELS = N // 128  # pivot launches per factor at n = 512
AUDIT_TARGET = 1e-4
#: The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): memory,
#: FP32 outside the tensor cores, bf16 on the tensor cores (dense).
PEAK_BYTES_S, PEAK_FP32_S, PEAK_BF16_S = 3.35e12, 67e12, 989e12
#: Kernel-vs-plain limit on max|kernel - plain| / max(max|plain|, 1). Both
#: sides are FP32 with the same operation order per element except for sum
#: order and FMA contraction; the pivot blocks of this family are
#: well-conditioned (cond ~ 10-100), so differences stay at a few f32 ulps
#: times the reduction depth (<= 512): 1e-5 as in tests/test_fused_admm.py.
LIMIT = 1e-5
#: The f64 witness of the M^{-1} chunks: from random iterates at rho >= 0.1
#: the K FP32 iterations of the prox chunk lose ~1e-5 of each output to
#: rounding on either side, so there the kernel and its plain version are
#: each held against the plain version run in f64 on the same inputs (the
#: f32 M^{-1} cast up). Per output, the kernel's error must stay within
#: WITNESS_RATIO times the plain version's, plus WITNESS_FLOOR of the
#: output's size: rounding gives ratios near 1, a fault a far larger error.
WITNESS_RATIO, WITNESS_FLOOR = 3.0, 1e-7
#: The "default" check (one iteration, K=1): the kernel against its plain
#: version, which rounds the same operands. Where the two differ by an ulp
#: in a sum order, a bf16 rounding can flip and move the elements that read
#: it by up to ~2e-3 of their output's max (a CPU emulation at phase 2's
#: shapes: 0.06-1.3 % of an output's elements beyond LIMIT of its max), so
#: the check counts elements: at most DEFAULT_SHARE of each output's may
#: differ from the plain version by more than LIMIT of its max. A kernel
#: that skips a rounding (of either operand, or of the check products) moves
#: 44-99 % of the elements of x, y, Ax or A'y. Every output that one
#: iteration moves must also differ from the kernel's own "highest" by more
#: than DEFAULT_GAP of its max (the emulation: >= 8e-4).
DEFAULT_SHARE, DEFAULT_GAP = 0.1, 1e-4
#: The bf16x3 level ("high") must differ from its own FP32 level on the
#: pivot rows (Dinv . T[j rows], a product of split operands alone) by more
#: than HIGH_GAP of their max. A CPU emulation at phase 2's shapes (the plain
#: versions): "high" 1.2e-5 from "highest" there, FP32 7.5e-7 from f64.
HIGH_GAP = 4e-6
#: Row 3's strip level (bf16x6 on the tensor cores) against a float64 run of
#: the level, over the two-launch FP32 witness's error (sequential fmaf
#: sums): at most X6_GATE times, max relative and relative Frobenius alike
#: (tests/test_torch_cuda.py: GATE), on the first GATE_LANES lanes.
X6_GATE, GATE_LANES = 1.5, 512
#: Row 3's SIMT FP32 strip kernel at phase 2's B=512, j=3, the kernel the
#: bf16x6 one replaced (PERF.md kernel table row 3, its best run, H100 80GB
#: HBM3 at 700 W): the bf16x6 kernel must not take longer.
SIMT_STRIP_MS = 1.3158

#: The kernels each main path must launch.
ADMM_PATH = ("slab_build", "pivot_sweep_v3", "slab_level", "admm_chunk")
PROX_PATH = ("slab_build", "pivot_sweep_v3", "slab_level", "prox_chunk")
ADMM_DEFAULTS_PATH = ("pivot_sweep_v3",)
ADMM_MINV_PATH = ("pivot_sweep_v3", "admm_chunk_minv")
PROX_MINV_PATH = ("pivot_sweep_v3", "prox_chunk_minv")
KERNELS = {
    "slab_build": ("csrc/slab_build.cu",
                   "quadraticprogramsolver_tpu/ops/fused_factor.py:80"),
    "pivot_sweep_v3": ("csrc/pivot_sweep.cu",
                       "quadraticprogramsolver_tpu/ops/spd_kernels.py:265"),
    "pivot_sweep_v3_prev": ("csrc/pivot_sweep.cu",
                            "quadraticprogramsolver_tpu/ops/spd_kernels.py:265"),
    "slab_build_prev": ("csrc/slab_build.cu",
                        "quadraticprogramsolver_tpu/ops/fused_factor.py:80"),
    "slab_level": ("csrc/slab_level.cu",
                   "quadraticprogramsolver_tpu/ops/fused_factor.py:131"),
    "slab_level_prev": ("csrc/slab_level.cu",
                        "quadraticprogramsolver_tpu/ops/fused_factor.py:131"),
    "admm_chunk": ("csrc/admm_chunk.cu",
                   "quadraticprogramsolver_tpu/ops/fused_admm.py:47"),
    "admm_chunk_cluster": ("csrc/admm_chunk_cluster.cu",
                           "quadraticprogramsolver_tpu/ops/fused_admm.py:47"),
    "prox_chunk": ("csrc/prox_chunk.cu",
                   "quadraticprogramsolver_tpu/ops/fused_proxqp.py:31"),
    "prox_chunk_cluster": ("csrc/prox_chunk_cluster.cu",
                           "quadraticprogramsolver_tpu/ops/fused_proxqp.py:31"),
    "admm_chunk_minv": ("csrc/admm_chunk.cu",
                        "quadraticprogramsolver_tpu/ops/fused_admm.py:47"),
    "prox_chunk_minv": ("csrc/prox_chunk.cu",
                        "quadraticprogramsolver_tpu/ops/fused_proxqp.py:31"),
    "admm_chunk_minv_cluster": ("csrc/admm_chunk_minv_cluster.cu",
                                "quadraticprogramsolver_tpu/ops/fused_admm.py:47"),
    "prox_chunk_minv_cluster": ("csrc/prox_chunk_minv_cluster.cu",
                                "quadraticprogramsolver_tpu/ops/fused_proxqp.py:31"),
}


#: The previous kernels kept beside their redesigns as bit-for-bit witnesses
#: and timing baselines (no solver launches them): witness -> its redesign.
WITNESSES = {"slab_build_prev": "slab_build",
             "slab_level_prev": "slab_level",
             "pivot_sweep_v3_prev": "pivot_sweep_v3",
             "admm_chunk": "admm_chunk_cluster",
             "prox_chunk": "prox_chunk_cluster",
             "admm_chunk_minv": "admm_chunk_minv_cluster",
             "prox_chunk_minv": "prox_chunk_minv_cluster",
             "ell_matvec_prev": "ell_matvec",
             "pivot_sweep_2d_prev": "pivot_sweep_2d",
             "pivot_sweep_v3p_prev": "pivot_sweep_v3p",
             "pivot_sweep_ref_prev": "pivot_sweep_ref",
             "normal_inverse_prev": "normal_inverse",
             "pivot_sweep_group_prev": "pivot_sweep_r2, pivot_sweep_r4, "
                                       "pivot_sweep_r8, pivot_sweep_panel",
             "routed_levels_prev": "routed_levels",
             "row_routed_rows": "row_routed_blocks"}
#: The counters (see counters()) of the wrappers that launch a kept previous
#: kernel, or one chunk kernel whatever the dispatch rule says: witnesses
#: and timing baselines only. Every path run reads them after its reset and
#: fails unless they stayed 0.
WITNESS_WRAPPERS = ("slab_build_prev", "slab_level_prev",
                    "pivot_sweep_v3_prev", "ell_matvec_prev",
                    "fused_admm_chunk_streaming", "fused_admm_chunk_cluster",
                    "fused_proxqp_chunk_streaming",
                    "fused_proxqp_chunk_cluster",
                    "fused_admm_chunk_minv_streaming",
                    "fused_admm_chunk_minv_cluster",
                    "fused_proxqp_chunk_minv_streaming",
                    "fused_proxqp_chunk_minv_cluster",
                    "pivot_sweep_2d_prev", "pivot_sweep_ref_prev",
                    "normal_inverse_prev", "pivot_sweep_group_prev",
                    "pivot_sweep_v3p_prev", "routed_levels_prev",
                    "row_routed_rows")
#: Phase 2b: the redesigns and their witnesses at the main path's B.
B_REDESIGN = B_MAIN
#: The triangle build's gram part against the previous kernel's: max |new -
#: prev| / max(max |prev|, 1). Its lower triangle is the mirror of the upper
#: one, which rounds rho_r A[r, j] where the previous kernel rounded rho_r
#: A[r, i]: an ulp of a product in sums of m of them, ~1e-7 of M's max.
MIRROR_TOL = 1e-6

#: Rows 4c and 5c: each chunk variant (a kernels-JSON entry of its own) ->
#: (the cluster kernel that runs it, the phase-8 stack whose launches it
#: reports, the token of its launch key: precision, G source or lanes).
#: Each is held bit for bit against, and timed in turns beside, the
#: streaming kernel of the same variant (its witness, ``stream_ms``).
VARIANTS = {
    "admm_chunk_high": ("admm_chunk_cluster", "8a", ",high,"),
    "admm_chunk_default": ("admm_chunk_cluster", "8a", ",default,"),
    "admm_chunk_split": ("admm_chunk_cluster", "8c", ",split,"),
    "admm_chunk_slab": ("admm_chunk_cluster", "8a", ",slab,"),
    "admm_chunk_lanes2": ("admm_chunk_cluster", "8a", ",lanes2,"),
    "admm_chunk_lanes4": ("admm_chunk_cluster", "8b", ",lanes4,"),
    "admm_chunk_minv_lanes2": ("admm_chunk_minv_cluster", "8f", ",lanes2,"),
    "prox_chunk_high": ("prox_chunk_cluster", "8e", ",high,"),
    "prox_chunk_default": ("prox_chunk_cluster", "8e", ",default,"),
    "prox_chunk_lanes2": ("prox_chunk_cluster", "8e", ",lanes2,"),
    "prox_chunk_minv_lanes2": ("prox_chunk_minv_cluster", "8g", ",lanes2,"),
}
#: Rows 7-10 and 3b: each pivot formulation and the bf16x3 level (a
#: kernels-JSON entry of its own) -> (its source, the TPU kernel it
#: replaces, the phase-9 stack whose launches it reports, its launch key).
#: "value" is v3's arithmetic (spd_kernels.py:251-262 against :286-294), so
#: it runs v3's kernel.
FACTOR_VARIANTS = {
    "pivot_sweep_ref": ("csrc/pivot_variants.cu",
                        "quadraticprogramsolver_tpu/ops/spd_kernels.py:199",
                        "9a", "ref"),
    "pivot_sweep_value": ("csrc/pivot_sweep.cu",
                          "quadraticprogramsolver_tpu/ops/spd_kernels.py:225",
                          "9b", "value"),
    **{f"pivot_sweep_r{q}": ("csrc/pivot_variants.cu",
                             "quadraticprogramsolver_tpu/ops/spd_kernels.py:298",
                             tag, f"r{q}")
       for q, tag in ((2, "9c"), (4, "9d"), (8, "9e"))},
    "pivot_sweep_panel": ("csrc/pivot_variants.cu",
                          "quadraticprogramsolver_tpu/ops/spd_kernels.py:349",
                          "9f", "panel"),
    "slab_level_high": ("csrc/slab_level.cu",
                        "quadraticprogramsolver_tpu/ops/fused_factor.py:151",
                        "9g", "high"),
}
#: Rows 6, 11 and 12, the package's other SPD-inverse entry points: each
#: kernel (a kernels-JSON entry of its own) -> (its source, the TPU kernel it
#: replaces). Their launches are phase 10's (one counted call each).
ENTRY_KERNELS = {
    "pivot_sweep_2d": ("csrc/pivot_sweep_2d.cu",
                       "quadraticprogramsolver_tpu/ops/spd_kernels.py:84"),
    "pivot_sweep_v3p": ("csrc/pivot_sweep_v3p.cu",
                        "quadraticprogramsolver_tpu/ops/spd_kernels.py:407"),
    "normal_inverse": ("csrc/normal_inverse.cu",
                       "quadraticprogramsolver_tpu/ops/spd_kernels.py:709"),
}
#: The first ports of rows 6, 7, 9-10, 11 and 12, kept beside their redesigns
#: as bit-for-bit witnesses (a kernels-JSON entry each): witness -> (its
#: source, the TPU kernel it replaces, the counted runs whose witness count
#: it reports: the phase-9 stacks named, or phase 10's counted call of its
#: successor when none is named).
ENTRY_WITNESSES = {
    "pivot_sweep_2d_prev": ("csrc/pivot_sweep_2d.cu",
                            "quadraticprogramsolver_tpu/ops/spd_kernels.py:84",
                            ()),
    "pivot_sweep_ref_prev": ("csrc/pivot_variants.cu",
                             "quadraticprogramsolver_tpu/ops/spd_kernels.py:199",
                             ("9a",)),
    "normal_inverse_prev": ("csrc/normal_inverse.cu",
                            "quadraticprogramsolver_tpu/ops/spd_kernels.py:709",
                            ()),
    "pivot_sweep_group_prev": ("csrc/pivot_variants.cu",
                               "quadraticprogramsolver_tpu/ops/spd_kernels.py:298",
                               ("9c", "9d", "9e", "9f")),
    "pivot_sweep_v3p_prev": ("csrc/pivot_sweep_v3p.cu",
                             "quadraticprogramsolver_tpu/ops/spd_kernels.py:407",
                             ()),
}
#: Row 11 in phase 2b: the batches at which the paired sweep is held to its
#: witness (phase 2's B, phase 10a's, the main path's).
B_PAIRED = (512, 3072, 4096)
#: The Schur inverse's device kernels by launch kind, as torch.profiler names
#: them (a fragment of each name): the two paired sweeps, the four products,
#: the three concatenations; the rest are its element-wise kernels.
SCHUR_KINDS = {"sweeps": "pivot_sweep_v3p_kernel", "products": "gemm",
               "concatenations": "CatArray"}
#: Rows 9 and 10: the group formulations that run group_sweep_kernel on the
#: main path's knobs (phase-9 stacks), each held to its witness.
GROUP_VARIANTS = ("r2", "r4", "r8", "panel")
#: Phase 10a: benchmarks/pivot_inverse_probe.py's defaults (B=3072 blocks
#: Dm'Dm/128 + 0.05 I) and its usability mark against an f64 inverse.
B_PROBE, PROBE_MARK = 3072, 1e-5
#: Phase 11: BASELINE config 4 as benchmarks/large_sparse.py runs it
#: (:84-112 with its defaults), and the SpMV probes' defaults.
SPARSE_N, SPARSE_EPS = 100_000, 1e-4
SPARSE_SETTINGS = dict(max_iterations=300, eps_abs=SPARSE_EPS,
                       eps_rel=SPARSE_EPS, rho=0.1, adaptive_rho=True,
                       cg_eps=1e-6, cg_max_iterations=200, cg_rel_eps=1e-4,
                       check_interval=25)
ROUTE_S = 8
#: routed_spmv_probe.py:181-183: (S, W, G) of the square micro kernel; the
#: G=1024 tall one resolves the per-slot cost and stands for row 14a.
MICRO_SHAPES = ((8, 128, 512), (32, 128, 512), (784, 128, 64),
                (784, 128, 1024), (8, 256, 96), (8, 1024, 96), (8, 12544, 8),
                (16, 6272, 8))
MICRO_MAIN = (784, 128, 1024)
#: The probes' own bar for a routed matvec against scipy in f64
#: (row_routed_probe.py:317).
SPMV_SCIPY_BAR = 1e-6
#: Phase 11d's banded case: the 2-D 5-point Laplacian on a BAND_K x BAND_K
#: grid (n = 99,856), where routing should pay (row_routed_probe.py:15-19).
BAND_K = 316
#: Rows 13-15: each SpMV kernel (a kernels-JSON entry of its own) -> (its
#: source, the TPU kernel it replaces). Row 13's launches are phase 11a's
#: solve; 14a, 14b and 15 are entry points, counted in one call each. Row
#: 14a (one dense level) runs the first port's routed_levels_prev_kernel
#: through routed_levels_matvec, counted there; the wrappers that launch
#: the first ports of 14b and 15 as witnesses (routed_levels_prev,
#: row_routed_rows) launch in no counted run.
SPMV_KERNELS = {
    "ell_matvec": ("csrc/ell_matvec.cu", "benchmarks/ell_kernel_probe.py:84"),
    "ell_matvec_prev": ("csrc/ell_matvec.cu",
                        "benchmarks/ell_kernel_probe.py:84"),
    "routed_levels_t1": ("csrc/routed_spmv.cu",
                         "benchmarks/routed_spmv_probe.py:189"),
    "routed_levels": ("csrc/routed_spmv.cu",
                      "benchmarks/routed_spmv_probe.py:299"),
    "routed_levels_prev": ("csrc/routed_spmv.cu",
                           "benchmarks/routed_spmv_probe.py:299"),
    "row_routed_blocks": ("csrc/row_routed.cu",
                          "benchmarks/row_routed_probe.py:204"),
    "row_routed_rows": ("csrc/row_routed.cu",
                        "benchmarks/row_routed_probe.py:204"),
}
T0 = time.perf_counter()


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


def cuda_ms(fn, reps=5, setup=None, inner=1):
    """Median ms of fn() over reps, CUDA events around each call (around
    ``inner`` back-to-back calls, divided by ``inner``, for kernels of a
    few microseconds)."""
    import torch

    times = []
    for _ in range(reps + 1):  # first call is a warm-up
        args = setup() if setup else ()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times[1:])


def compare(name, kern, plain, failures, phase="phase 2"):
    """max|kernel - plain| over matching outputs; a breach of LIMIT is
    appended to ``failures`` (checked once every kernel has been compared)."""
    import torch

    if isinstance(kern, torch.Tensor):
        kern, plain = (kern,), (plain,)
    err = max(float((k - p).abs().max()) for k, p in zip(kern, plain))
    scale = max(max(float(p.abs().max()) for p in plain), 1.0)
    rel = err / scale
    finite = all(bool(torch.isfinite(k).all()) for k in kern)
    log(f"[{phase}] {name}: max abs err {err:.3e}, relative {rel:.3e} "
        f"(limit {LIMIT:.0e}), finite={finite}")
    if not (finite and rel <= LIMIT):
        failures.append(f"{name}: kernel disagrees with its plain version "
                        f"(relative {rel:.3e} > {LIMIT:.0e}, finite={finite})")
    return err


def witness(label, name, kern_fn, plain_fn, args, kw, outs, failures):
    """Per output: |kernel - f64|, |plain - f64| and |kernel - plain|, each
    also relative to max|f64 output|; a breach of the witness rule is
    appended to ``failures``. Returns the largest relative kernel error."""
    import torch

    k = kern_fn(*args, **kw)
    p = plain_fn(*args, **kw)
    w = plain_fn(*(a.double() if a is not None and a.is_floating_point()
                   else a for a in args), **kw)
    worst = 0.0
    for nm, ko, po, wo in zip(outs, k, p, w):
        scale = max(float(wo.abs().max()), 1e-30)
        ek = float((ko.double() - wo).abs().max())
        ep = float((po.double() - wo).abs().max())
        ekp = float((ko - po).abs().max())
        finite = bool(torch.isfinite(ko).all())
        log(f"[{label}] {name} {nm}: |kernel - f64| {ek:.3e} ({ek / scale:.2e} "
            f"of max|{nm}| {scale:.3e}), |plain - f64| {ep:.3e} "
            f"({ep / scale:.2e}), |kernel - plain| {ekp:.3e} "
            f"({ekp / scale:.2e}), finite={finite}")
        if not (finite and ek <= WITNESS_RATIO * ep + WITNESS_FLOOR * scale):
            failures.append(f"{label} {name} {nm}: kernel error {ek:.3e} "
                            f"against the f64 witness > {WITNESS_RATIO} x the "
                            f"plain version's {ep:.3e} + {WITNESS_FLOOR:.0e} x "
                            f"{scale:.3e} (finite={finite})")
        worst = max(worst, ek / scale)
    return worst


def prox_minv_witness(torch, prob, rho, iterates, active, label, failures):
    """The M^{-1} prox chunk (K_MINV iterations, REFINE passes, sigma 1e-2;
    the cluster kernel, bit for bit the streaming one in phase 2) against
    its f64 witness at the per-lane penalties ``rho``, from the
    iterates (x, s, y, z)."""
    from quadraticprogramsolver_tpu_torch.ops import fused_proxqp, linalg

    sigma = 1e-2
    Mn = prob.P + sigma * torch.eye(prob.n, device=DEVICE) + rho[:, None, None] * (
        prob.A.transpose(1, 2) @ prob.A + prob.C.transpose(1, 2) @ prob.C)
    Minv = linalg.spd_inverse(Mn)
    del Mn
    args = (Minv, prob.A, prob.C, prob.P, prob.q, prob.b, prob.d, *iterates,
            rho, active)
    return witness(label, "prox_chunk_minv_cluster",
                   fused_proxqp.fused_proxqp_chunk_minv_cluster,
                   fused_proxqp.fused_proxqp_chunk_minv_plain, args,
                   dict(K=K_MINV, sigma=sigma, refine=REFINE), "xsyz", failures)


def default_check(name, kern_fn, plain_fn, args, kw, outs, failures):
    """The "default" kernel at K=1 against its plain version, and against
    its own "highest" (DEFAULT_SHARE, DEFAULT_GAP); a breach is appended to
    ``failures``."""
    import torch

    def run(fn, prec):
        return fn(*args, **dict(kw, K=1, dot_precision=prec))

    k, p = run(kern_fn, "default"), run(plain_fn, "default")
    kh, ph = run(kern_fn, "highest"), run(plain_fn, "highest")
    for nm, ko, po, kho, pho in zip(outs, k, p, kh, ph):
        scale = max(float(po.abs().max()), 1e-30)
        d = (ko - po).abs()
        share = float((d > LIMIT * scale).float().mean())
        gap = float((ko - kho).abs().max()) / max(float(kho.abs().max()), 1e-30)
        moves = not torch.equal(po, pho)  # x_prev, z_prev: the inputs
        finite = bool(torch.isfinite(ko).all())
        log(f"[phase 2 default check] {name} {nm} (K=1): max |kernel - plain| "
            f"{float(d.max()):.3e} ({float(d.max()) / scale:.2e} of max), share "
            f"beyond {LIMIT:.0e} of max {share:.4f} (limit {DEFAULT_SHARE}), "
            f"kernel default vs highest {gap:.2e}"
            + (f" (must exceed {DEFAULT_GAP:.0e})" if moves else ""))
        if not (finite and share <= DEFAULT_SHARE):
            failures.append(f"{name} {nm}: at K=1 {share:.4f} of the elements "
                            f"differ from the plain version by more than "
                            f"{LIMIT:.0e} of max (limit {DEFAULT_SHARE}, "
                            f"finite={finite})")
        if moves and not gap > DEFAULT_GAP:
            failures.append(f"{name} {nm}: \"default\" differs from "
                            f"\"highest\" by {gap:.2e} <= {DEFAULT_GAP:.0e} "
                            "of max: no bf16 rounding")


def limit_or_witness(label, name, kern_fn, plain_fn, args, failures, k=None):
    """An inverse kernel against its plain version: by LIMIT, or where FP32
    rounding alone fills LIMIT (the unscaled sweeps on spread diagonals) by
    the f64 witness of its plain version. Returns max |kernel - plain|."""
    k = kern_fn(*args) if k is None else k
    p = plain_fn(*args)
    rel = float((k - p).abs().max()) / max(float(p.abs().max()), 1.0)
    if rel <= LIMIT:
        return compare(label, k, p, failures)
    witness(f"phase 2 witness, {label}", name, lambda *a: (kern_fn(*a),),
            lambda *a: (plain_fn(*a),), args, {}, ("inverse",), failures)
    log(f"[phase 2] {label}: relative {rel:.3e} held by the f64 witness")
    return float((k - p).abs().max())


def variant(out, failures, name, kern_fn, plain_fn, args, kw, nbytes, flops,
            witness_outs=None, same_as=None, limit=False, *, stream_fn, extra):
    """One chunk variant of row 4c or 5c, launched through the solver's
    dispatching wrapper ``kern_fn``, which must send it to a cluster kernel
    (its launch key ends in ",cluster"), against its plain version: by the
    f64 witness (``witness_outs``: "high" and "default", where a 1-ulp
    difference can flip a bf16 rounding), by LIMIT (``limit``: FP32
    variants), bit for bit against ``same_as``, the outputs of the variant
    it must equal (lanes 1, a contiguous G, G split in registers), and bit
    for bit against ``stream_fn``, the streaming kernel of the same variant
    (its witness), timed in turns beside it (``extra[name]["stream_ms"]``).
    ``flops``: (FP32 FLOPs, bf16 FLOPs) for the bound. Records (max |kernel
    - plain|, kernel ms, plain ms, None, bound) in ``out`` and returns the
    kernel's outputs."""
    import torch

    before = dict(kern_fn.variants)
    k = kern_fn(*args, **kw)
    keys = [key for key, v in kern_fn.variants.items() if v != before.get(key, 0)]
    log(f"[phase 2] {name}: launched as {keys}")
    if not (len(keys) == 1 and keys[0].endswith(",cluster")):
        failures.append(f"{name}: not launched as a cluster kernel: {keys}")
    p = plain_fn(*args, **kw)
    if limit:
        err = compare(name, k, p, failures)
    else:
        err = max(float((a - b).abs().max()) for a, b in zip(k, p))
        log(f"[phase 2] {name}: max |kernel - plain| {err:.3e} (held by "
            + ("the f64 witness)" if witness_outs else "its identity)"))
    if witness_outs:
        witness(f"phase 2 witness, {name}", name, kern_fn, plain_fn, args, kw,
                witness_outs, failures)
    if same_as is not None:
        same = all(torch.equal(a, b) for a, b in zip(k, same_as))
        log(f"[phase 2] {name}: bit for bit equal to its identity: {same}")
        if not same:
            failures.append(f"{name}: not bit for bit equal to its identity")
    ws = stream_fn(*args, **kw)
    same = all(torch.equal(a, b) for a, b in zip(k, ws))
    ms_s, ms_k = in_turns(lambda: stream_fn(*args, **kw),
                          lambda: kern_fn(*args, **kw))
    log(f"[phase 2] {name}: bit for bit the streaming kernel of the same "
        f"variant: {same}; cluster {ms_k:.4f} ms, streaming {ms_s:.4f} ms "
        f"({ms_s / ms_k:.2f}x, in turns)")
    if not same:
        failures.append(f"{name}: not the streaming kernel's bits")
    extra.setdefault(name, {})["stream_ms"] = ms_s
    out[name] = (err, ms_k, cuda_ms(lambda: plain_fn(*args, **kw)), None,
                 bound(nbytes, *flops))
    return k


def bound(nbytes, flops, bf16_flops=0):
    """(ms, "bytes" | "operations"): the least time the card could take;
    ``flops`` at the FP32 rate, ``bf16_flops`` (products of two bf16
    operands, summed in FP32) at the bf16 tensor-core rate."""
    tb = nbytes / PEAK_BYTES_S
    tf = flops / PEAK_FP32_S + bf16_flops / PEAK_BF16_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def pivot_bound(B):
    """An SPD inverse of a 128 x 128 block (Cholesky, then the inverse from
    it) is 128^3 FLOPs; each block read once and written once."""
    return bound(4 * 2 * B * 128 * 128, B * 128 ** 3)


def spread_blocks(torch, B, g):
    """(B, 128, 128) SPD blocks with a spread of diagonal magnitudes
    (tests/test_torch_spd_kernels.py's: X X'/128 + I scaled by exp(U(-2, 2))
    on each side), made on the card in float64 and rounded to float32."""
    X = torch.randn((B, 128, 128), generator=g, device=DEVICE, dtype=torch.float64)
    D = X @ X.transpose(1, 2) / 128 + torch.eye(128, device=DEVICE, dtype=torch.float64)
    s = torch.exp(4 * torch.rand((B, 128), generator=g, device=DEVICE,
                                 dtype=torch.float64) - 2)
    return (D * s[:, :, None] * s[:, None, :]).float()


def sweep_pair(torch, label, name, new, prev, blocks, failures, cold=False):
    """A redesigned sweep (``new``) against its witness (``prev``, the
    first port) on each of ``blocks`` (kind -> (B, n, n) blocks), bit for
    bit; then both timed in turns on the first kind: by cuda_ms, or with
    ``cold`` in device time (``device_ms``, for kernels shorter than a
    call's host work) with each call on its own copy of the blocks
    (``pitched_copies``), so that they come from device memory and not
    from the L2. Returns (new ms, previous ms)."""
    for kind, D in blocks.items():
        same = torch.equal(new(D), prev(D))
        log(f"[{label}] B={D.shape[0]} {name} ({kind} blocks): bit for bit "
            f"its witness: {same}")
        if not same:
            failures.append(f"{label}: {name} ({kind} blocks) is not the "
                            "previous kernel's bits")
    D = next(iter(blocks.values()))
    if cold:
        copies = pitched_copies(torch, D)
        ms_prev, ms_new = in_turns([lambda c=c: prev(c) for c in copies],
                                   [lambda c=c: new(c) for c in copies],
                                   device_ms)
        del copies
    else:
        ms_prev, ms_new = in_turns(lambda: prev(D), lambda: new(D))
    log(f"[{label}] B={D.shape[0]} {name} {ms_new:.4f} ms, witness "
        f"{ms_prev:.4f} ms ({ms_prev / ms_new:.2f}x, in turns"
        + (", device time from memory)" if cold else ")"))
    return ms_new, ms_prev


def pitched_copies(torch, D):
    """Copies of the (B, n, n) blocks D, each a view of its own (B, n, 2n)
    buffer (read with a row pitch, as a block of a wider matrix is), enough
    that a call on each in turn reads its blocks from device memory and not
    from the L2: together at least three times the L2's size, and at least
    2."""
    B, n, _ = D.shape
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    copies = []
    for _ in range(max(2, -(-3 * l2 // D.nbytes))):
        buf = torch.empty((B, n, 2 * n), device=D.device, dtype=D.dtype)
        buf[..., :n] = D
        copies.append(buf[..., :n])
    return copies


def phase_factor_kernels(torch, D, Sp, Dp, j, w_out, g, out, extra, failures):
    """Rows 7-10 and 3b: each pivot formulation against its plain version
    (LIMIT; "ref", unscaled, by the f64 witness where FP32 rounding alone
    fills LIMIT) and "value" bit for bit against v3, on the slab's pivot
    blocks ``D`` and on spread-diagonal blocks; "ref" and the group
    formulations (GROUP_VARIANTS) also bit for bit their first ports
    (``pivot_sweep_ref_prev``, ``pivot_sweep_group_prev``) and timed beside
    them in turns, their numbers beyond ``out``'s in ``extra``; then the
    bf16x3 level at level ``j`` against its plain version (LIMIT), apart
    from its own FP32 level on the pivot rows (HIGH_GAP), and bit for bit
    the two-launch bf16x3 level (``slab_level_prev`` at "high"), timed in
    turns beside it."""
    from quadraticprogramsolver_tpu_torch.ops import fused_factor, spd_kernels

    inv = spd_kernels.spd_inverse_unrolled
    blocks = {"slab": D, "spread": spread_blocks(torch, D.shape[0], g)}
    v3 = {kind: inv(Dk) for kind, Dk in blocks.items()}
    for name, (_, _, _, variant) in FACTOR_VARIANTS.items():
        if variant == "high":
            continue
        errs = []
        for kind, Dk in blocks.items():
            k = inv(Dk, variant=variant)
            if variant == "value":
                same = torch.equal(k, v3[kind])
                log(f"[phase 2] {name} ({kind} blocks): bit for bit equal to "
                    f"pivot_sweep_v3: {same}")
                if not same:
                    failures.append(f"{name} ({kind} blocks): not v3's bits")
            if variant == "ref":
                # No Jacobi scaling: the folded fix loses digits on spread
                # diagonals on both sides alike.
                errs.append(limit_or_witness(
                    f"{name} ({kind} blocks)", name,
                    lambda x: inv(x, variant="ref"),
                    spd_kernels.pivot_sweep_ref_plain, (Dk,), failures, k))
            else:
                errs.append(compare(f"{name} ({kind} blocks)", k,
                                    spd_kernels.pivot_sweep_plain(Dk, variant),
                                    failures))
        # On the slab's blocks: the kernel, its plain version ("value":
        # v3's) and the library inverse.
        plain_ms = cuda_ms(lambda v=variant: spd_kernels.pivot_sweep_plain(D, v))
        lib_ms = cuda_ms(lambda: torch.linalg.inv(D))
        if variant == "ref":
            prev = spd_kernels.pivot_sweep_ref_prev
            ms, ms_prev = sweep_pair(torch, "phase 2", name,
                                     lambda x: inv(x, variant="ref"), prev,
                                     blocks, failures)
            out[f"{name}_prev"] = (
                limit_or_witness(f"{name}_prev (slab blocks)", f"{name}_prev",
                                 prev, spd_kernels.pivot_sweep_ref_plain, (D,),
                                 failures),
                ms_prev, plain_ms, lib_ms, pivot_bound(D.shape[0]))
            extra[name] = {"witness_ms": ms_prev}
        elif variant in GROUP_VARIANTS:
            prev = spd_kernels.pivot_sweep_group_prev
            ms, ms_prev = sweep_pair(torch, "phase 2", name,
                                     lambda x, v=variant: inv(x, variant=v),
                                     lambda x, v=variant: prev(x, v), blocks,
                                     failures)
            extra[name] = {"witness_ms": ms_prev}
            if variant == GROUP_VARIANTS[0]:
                # The witness's entry: its numbers at the first formulation.
                out["pivot_sweep_group_prev"] = (
                    compare("pivot_sweep_group_prev (slab blocks)",
                            prev(D, variant),
                            spd_kernels.pivot_sweep_plain(D, variant), failures),
                    ms_prev, plain_ms, lib_ms, pivot_bound(D.shape[0]))
            extra.setdefault("pivot_sweep_group_prev", {})[f"{variant}_ms"] = ms_prev
        else:
            ms = cuda_ms(lambda v=variant: inv(D, variant=v))
        out[name] = (errs[0], ms, plain_ms, lib_ms, pivot_bound(D.shape[0]))

    rows = slice(j * 128, (j + 1) * 128)
    Sh, Sf, Sq = Sp.clone(), Sp.clone(), Sp.clone()
    fused_factor.slab_level(Sh, Dp, j, w_out, dot_precision="high")
    fused_factor.slab_level(Sf, Dp, j, w_out)
    fused_factor.slab_level_plain(Sq, Dp, j, w_out, "high")
    err = compare("slab_level_high", Sh[:, :, :w_out], Sq[:, :, :w_out], failures)
    if not torch.equal(Sh[:, :, w_out:], Sp[:, :, w_out:]):
        failures.append("slab_level_high wrote outside the live region")
    gap = (float((Sh[:, rows, :w_out] - Sf[:, rows, :w_out]).abs().max())
           / float(Sf[:, rows, :w_out].abs().max()))
    log(f"[phase 2] slab_level_high: pivot rows apart from the FP32 level by "
        f"{gap:.3e} of their max (must exceed {HIGH_GAP:.0e})")
    if not gap > HIGH_GAP:
        failures.append(f"slab_level_high: {gap:.3e} from the FP32 level <= "
                        f"{HIGH_GAP:.0e}: no bf16x3 rounding")
    del Sh, Sf, Sq
    B, n = Sp.shape[:2]
    ms, ms_prev = level_pair(torch, Sp, Dp, j, w_out, "phase 2", failures, "high")
    out["slab_level_high"] = (
        err, ms,
        cuda_ms(lambda S: fused_factor.slab_level_plain(S, Dp, j, w_out, "high"),
                setup=lambda: (Sp.clone(),)),
        None, level_bound(B, n, w_out, "high"))
    extra["slab_level_high"] = {"witness_ms": ms_prev}


def phase_entry_kernels(torch, D, qp, out, extra, failures):
    """Rows 6, 11 and 12 at phase 2's shapes, each against its plain version
    (LIMIT, or the f64 witness where FP32 rounding alone fills it) and timed
    beside its library call, rows 6, 11 and 12 also bit for bit their first
    ports (``pivot_sweep_2d_prev``, ``pivot_sweep_v3p_prev``,
    ``normal_inverse_prev``) and timed beside them in turns: the round-1
    sweep on the slab's pivot blocks
    ``D`` (and on spread-diagonal blocks, and under its zero-pivot guard)
    beside ``torch.linalg.inv``; the
    paired-64 sweep on their leading 64-blocks beside ``torch.linalg.inv`` on
    those, and the Schur inverse of ``D`` (``schur_split``); the
    normal-matrix inverse of
    ``qp``'s P and A with per-lane rho in [0.1, 10] beside the library
    Cholesky inverse of a torch-built M and the port's M^{-1} route
    (``spd_inverse(_build_normal_matrix(...))``). Numbers beyond ``out``'s
    go to ``extra[kernel]`` for the kernels JSON."""
    from quadraticprogramsolver_tpu_torch.models import kkt
    from quadraticprogramsolver_tpu_torch.ops import linalg, spd_kernels as sk

    B = D.shape[0]
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    spread = spread_blocks(torch, B, g)
    nb_plain = lambda x: sk.sweep_inverse_block_plain(x, guard_zero=True)  # noqa: E731
    errs = [limit_or_witness(f"pivot_sweep_2d ({kind} blocks)", "pivot_sweep_2d",
                             sk.spd_inverse_nb, nb_plain, (Dk,), failures)
            for kind, Dk in (("slab", D), ("spread", spread))]
    zero = D.clone()
    zero[:, 5, :] = 0.0
    zero[:, :, 5] = 0.0
    ms_new, ms_prev = sweep_pair(
        torch, "phase 2", "pivot_sweep_2d", sk.spd_inverse_nb,
        sk.pivot_sweep_2d_prev,
        {"slab": D, "spread": spread, "zero-pivot": zero}, failures)
    del zero
    plain_ms, lib_ms = cuda_ms(lambda: nb_plain(D)), cuda_ms(lambda: torch.linalg.inv(D))
    out["pivot_sweep_2d"] = (errs[0], ms_new, plain_ms, lib_ms, pivot_bound(B))
    out["pivot_sweep_2d_prev"] = (
        limit_or_witness("pivot_sweep_2d_prev (slab blocks)", "pivot_sweep_2d_prev",
                         sk.pivot_sweep_2d_prev, nb_plain, (D,), failures),
        ms_prev, plain_ms, lib_ms, pivot_bound(B))
    extra["pivot_sweep_2d"] = {"witness_ms": ms_prev}

    D64, spread64 = D[:, :64, :64], spread[:, :64, :64]
    errs = [limit_or_witness(f"pivot_sweep_v3p ({kind} blocks)", "pivot_sweep_v3p",
                             sk.spd_inverse_64p, sk.pivot_sweep_v3p_plain,
                             (Dk,), failures)
            for kind, Dk in (("slab", D64), ("spread", spread64))]
    # Row 11 bit for bit its first port, both timed in turns on the device
    # alone (a call's host work outlasts either kernel), from memory.
    ms_new, ms_prev = sweep_pair(
        torch, "phase 2", "pivot_sweep_v3p", sk.spd_inverse_64p,
        sk.pivot_sweep_v3p_prev, {"slab": D64, "spread": spread64}, failures,
        cold=True)
    plain_ms = cuda_ms(lambda: sk.pivot_sweep_v3p_plain(D64))
    lib_ms = cuda_ms(lambda: torch.linalg.inv(D64))
    bnd = bound(4 * 2 * B * 64 * 64, B * 64 ** 3)
    out["pivot_sweep_v3p"] = (errs[0], ms_new, plain_ms, lib_ms, bnd)
    out["pivot_sweep_v3p_prev"] = (
        limit_or_witness("pivot_sweep_v3p_prev (slab blocks)",
                         "pivot_sweep_v3p_prev", sk.pivot_sweep_v3p_prev,
                         sk.pivot_sweep_v3p_plain, (D64,), failures),
        ms_prev, plain_ms, lib_ms, bnd)
    ref = torch.linalg.inv(D.double())
    schur_err = float((sk.spd_inverse_128_schur(D).double() - ref).abs().max()
                      / ref.abs().max())
    extra["pivot_sweep_v3p"] = {
        "witness_ms": ms_prev, "schur_rel_err_f64": schur_err,
        "schur_library_ms": out["pivot_sweep_2d"][3],
        **schur_split(torch, D, "phase 2")}
    log(f"[phase 2] spd_inverse_128_schur (B={B}): {schur_err:.3e} from f64 "
        f"relative to its max, beside torch.linalg.inv "
        f"{out['pivot_sweep_2d'][3]:.4f} ms")
    del spread, spread64, ref

    n, m, sigma = qp.n, qp.m, 1e-6
    rho = 0.1 * 100.0 ** torch.rand(B, generator=g, device=DEVICE)
    args = (qp.P, qp.A, rho)
    ni_plain = lambda *a: sk.normal_inverse_plain(*a, sigma)  # noqa: E731
    ni = lambda *a: sk.normal_inverse(*a, sigma=sigma)  # noqa: E731
    ni_prev = lambda *a: sk.normal_inverse_prev(*a, sigma=sigma)  # noqa: E731
    err = limit_or_witness("normal_inverse", "normal_inverse", ni, ni_plain,
                           args, failures)
    err_prev = limit_or_witness("normal_inverse_prev", "normal_inverse_prev",
                                ni_prev, ni_plain, args, failures)
    same = torch.equal(ni(*args), ni_prev(*args))
    log(f"[phase 2] normal_inverse (B={B}, n={n}, m={m}, per-lane rho): bit "
        f"for bit normal_inverse_prev: {same}")
    if not same:
        failures.append("normal_inverse is not the previous kernels' bits")
    ms_prev, ms_new = in_turns(lambda: ni_prev(*args), lambda: ni(*args))
    log(f"[phase 2] B={B} normal_inverse {ms_new:.4f} ms, normal_inverse_prev "
        f"{ms_prev:.4f} ms ({ms_prev / ms_new:.2f}x, in turns)")
    eye = torch.eye(n, device=DEVICE)
    library = lambda: torch.cholesky_inverse(torch.linalg.cholesky(  # noqa: E731
        qp.P + sigma * eye + rho[:, None, None] * (qp.A.transpose(1, 2) @ qp.A)))
    rho_row = rho[:, None].expand(B, m).contiguous()
    route = lambda: linalg.spd_inverse(  # noqa: E731
        kkt._build_normal_matrix(qp, rho_row, sigma))
    plain_ms, lib_ms = cuda_ms(lambda: ni_plain(*args)), cuda_ms(library)
    bnd = normal_inverse_bound(B, n, m)
    out["normal_inverse"] = (err, ms_new, plain_ms, lib_ms, bnd)
    out["normal_inverse_prev"] = (err_prev, ms_prev, plain_ms, lib_ms, bnd)
    extra["normal_inverse"] = {"route_ms": cuda_ms(route), "witness_ms": ms_prev}
    log(f"[phase 2] normal_inverse: the port's M^-1 route (build + sweep) "
        f"{extra['normal_inverse']['route_ms']:.4f} ms (median of 5)")


def schur_split(torch, D, label):
    """Where ``spd_inverse_128_schur``'s time goes on the (B, 128, 128)
    blocks D: one call traced by torch.profiler, its device ms and launches
    by kind (SCHUR_KINDS, and the element-wise rest), the call's time
    (CUDA events around one call, median of 5: the host's launches
    included) and its device time alone (``device_ms``, each call on its
    own copy of D from ``l2_copies``, so from memory), beside row 2's
    direct v3 sweep on the same blocks (both ways). The call must trace two
    paired sweeps and no witness."""
    from quadraticprogramsolver_tpu_torch.ops import spd_kernels as sk

    B = D.shape[0]
    schur = lambda: sk.spd_inverse_128_schur(D)  # noqa: E731
    v3 = lambda: sk.spd_inverse_unrolled(D, variant="v3")  # noqa: E731
    kernels = device_kernels(torch, schur)
    split = by_kind(kernels, SCHUR_KINDS)
    total = sum(ms for _, ms in kernels.values())
    split["element-wise"] = (sum(c for c, _ in kernels.values())
                             - sum(c for c, _ in split.values()),
                             total - sum(ms for _, ms in split.values()))
    require(split["sweeps"][0] == 2 and not any(
        "prev" in k for k in kernels), f"{label}: one Schur call traced "
        f"{kernels}, not two paired sweeps and no witness")
    copies = l2_copies(D)
    res = {"schur_ms": cuda_ms(schur),
           "schur_device_ms": device_ms(
               [lambda c=c: sk.spd_inverse_128_schur(c[0]) for c in copies]),
           "schur_traced_device_ms": total,
           "schur_split_ms": {k: ms for k, (_, ms) in split.items()},
           "schur_split_launches": {k: c for k, (c, _) in split.items()},
           "v3_ms": cuda_ms(v3),
           "v3_device_ms": device_ms(
               [lambda c=c: sk.spd_inverse_unrolled(c[0], variant="v3")
                for c in copies])}
    del copies
    log(f"[{label}] B={B} spd_inverse_128_schur: {res['schur_ms']:.4f} ms a "
        f"call (median of 5), {res['schur_device_ms']:.4f} ms of device time "
        f"from memory (queued calls); one traced call {total:.4f} ms of kernels: "
        + ", ".join(f"{k} {ms:.4f} ({c})" for k, (c, ms) in split.items())
        + f"; row 2's v3 sweep on the same blocks {res['v3_ms']:.4f} ms a "
        f"call, {res['v3_device_ms']:.4f} ms of device time from memory")
    log(f"[{label}] the Schur call's kernels (launches, device ms): {kernels}")
    return res


def normal_inverse_bound(B, n, m):
    """P and A read once, rho, M^{-1} written once; per lane the gram's
    distinct entries (n(n+1)m FLOPs) and one SPD inverse (n^3)."""
    return bound(4 * B * (2 * n * n + m * n + 1), B * (n * (n + 1) * m + n ** 3))


def slab_build_bound(B, n, ms):
    m = sum(ms)
    kp = -(-(m + 1) // 64) * 64
    nbytes = 4 * (B * n * n + B * m * n + B * n + B * m + B * n * (kp + n))
    # P + sum A_i' W_i A_i is symmetric: n(n+1)/2 entries of 2m FLOPs each.
    return bound(nbytes, B * n * (n + 1) * m)


def level_bound(B, n, w_out, dot_precision="highest"):
    """The live region and the pivot columns read once, Dinv read, the live
    region written; Dinv . (pivot rows) for the 128 pivot rows, S - C .
    DinvT for the other n - 128: 2 * 128 * w_out FLOPs a row, six bf16
    passes at "highest" (bf16x6), three at "high"."""
    nbytes = 4 * B * (n * (w_out + 128) + 128 * 128 + n * w_out)
    flops = 2 * B * 128 * w_out * n
    return bound(nbytes, 0, (3 if dot_precision == "high" else 6) * flops)


def yardstick_ms(torch, B, n, m, w_out, g):
    """The card's FP32 rate on each redesigned kernel's dominant products:
    ms of one torch.baddbmm (TF32 off) at the level's (B, n - 128, 128) .
    (B, 128, w_out) and the gram's (B, n, m) . (B, m, n), on random
    operands. A yardstick only: no one call computes a level or a slab."""
    r = lambda *shape: torch.randn(shape, generator=g, device=DEVICE)  # noqa: E731
    T, C, D = r(B, n - 128, w_out), r(B, n - 128, 128), r(B, 128, w_out)
    level = cuda_ms(lambda: torch.baddbmm(T, C, D, alpha=-1))
    del T, C, D
    P, At, A = r(B, n, n), r(B, n, m), r(B, m, n)
    gram = cuda_ms(lambda: torch.baddbmm(P, At, A))
    return {"slab_level": level, "slab_build": gram}


def build_pair(torch, args, label, failures):
    """The triangle build (``build_slab``) against the previous kernels
    (``build_slab_prev``) on ``args``: [A' | q | 0] and M's upper triangle
    bit for bit; the gram part of M exactly symmetric (M is P plus the gram
    of a P = 0 build, element for element, and that gram equals its
    transpose); within MIRROR_TOL of the previous kernel. Returns (new ms,
    previous ms), timed in turns."""
    from quadraticprogramsolver_tpu_torch.ops import fused_factor as ff

    P, A, q, rho, sigma = args
    n, kp = q.shape[-1], ff.slab_k(rho.shape[-1])
    new = ff.build_slab(*args)
    prev = ff.build_slab_prev(*args)
    rhs = torch.equal(new[..., :kp], prev[..., :kp])
    M, Mp = new[..., kp:], prev[..., kp:]
    upper = torch.equal(torch.triu(M), torch.triu(Mp))
    rel = float((M - Mp).abs().max()) / max(float(Mp.abs().max()), 1.0)
    del prev, Mp
    gram = ff.build_slab(torch.zeros_like(P), A, q, rho, sigma)[..., kp:].contiguous()
    mirror = torch.equal(gram, gram.transpose(1, 2)) and torch.equal(M, P + gram)
    del new, M, gram
    log(f"[{label}] slab_build: [A' | q | 0] bit for bit build_slab_prev: "
        f"{rhs}; upper triangle: {upper}; gram exactly symmetric: {mirror}; "
        f"{rel:.3e} from build_slab_prev (limit {MIRROR_TOL:.0e})")
    if not (rhs and upper and mirror and rel <= MIRROR_TOL):
        failures.append(f"{label}: the triangle build is not the previous "
                        f"kernel's bits and mirror ({rhs}, {upper}, {mirror}, "
                        f"{rel:.3e})")
    ms_prev, ms_new = in_turns(lambda: ff.build_slab_prev(*args),
                               lambda: ff.build_slab(*args))
    return ms_new, ms_prev


def level_errors(x, ref):
    """(max |x - ref| / max |ref|, ||x - ref||_F / ||ref||_F), ref float64."""
    d = x.double() - ref
    return float(d.abs().max() / ref.abs().max()), float(d.norm() / ref.norm())


def level_pair(torch, Sp, Dinv, j, w_out, label, failures, prec="highest"):
    """The strip level (``slab_level``) against the previous two-launch
    level (``slab_level_prev``) of precision ``prec`` at level ``j`` on a
    copy of ``Sp``: at "high" bit for bit on the whole slab; at "highest"
    (bf16x6 on the tensor cores) by the accuracy gate, both against a
    float64 run of the level on the first GATE_LANES lanes, the strip
    kernel's errors within X6_GATE of the witness's. Returns (new ms,
    previous ms), timed in turns, each call on a fresh copy."""
    from quadraticprogramsolver_tpu_torch.ops import fused_factor as ff

    S1, S2 = Sp.clone(), Sp.clone()
    ff.slab_level(S1, Dinv, j, w_out, prec)
    ff.slab_level_prev(S2, Dinv, j, w_out, dot_precision=prec)
    name = "slab_level" + ("_high" if prec == "high" else "")
    if prec == "high":
        same = torch.equal(S1, S2)
        log(f"[{label}] B={Sp.shape[0]} {name} (j={j}, w_out={w_out}): the "
            f"whole slab bit for bit slab_level_prev at {prec!r}: {same}")
        if not same:
            failures.append(f"{label}: {name} is not the previous kernel's bits")
    else:
        b = min(GATE_LANES, Sp.shape[0])
        ref = Sp[:b].double()
        ff.slab_level_plain(ref, Dinv[:b].double(), j, w_out)
        (e1, f1), (e2, f2) = (level_errors(S[:b, :, :w_out], ref[..., :w_out])
                              for S in (S1, S2))
        ok = e1 <= X6_GATE * e2 and f1 <= X6_GATE * f2
        log(f"[{label}] B={Sp.shape[0]} {name} (j={j}, w_out={w_out}) against "
            f"float64 on {b} lanes: max relative {e1:.3e}, relative Frobenius "
            f"{f1:.3e}; the FP32 witness {e2:.3e}, {f2:.3e} ({e1 / e2:.2f}x, "
            f"{f1 / f2:.2f}x; gate {X6_GATE}x): {ok}")
        if not ok:
            failures.append(f"{label}: {name}'s error against float64 "
                            f"({e1:.3e}, {f1:.3e}) over {X6_GATE}x the FP32 "
                            f"witness's ({e2:.3e}, {f2:.3e})")
        del ref
    del S1, S2
    scratch = torch.empty((Sp.shape[0], 128, w_out), device=DEVICE)
    fresh = lambda fn: cuda_ms(fn, setup=lambda: (Sp.clone(),))  # noqa: E731
    return tuple(reversed(in_turns(
        lambda S: ff.slab_level_prev(S, Dinv, j, w_out, scratch, prec),
        lambda S: ff.slab_level(S, Dinv, j, w_out, prec), timer=fresh)))


def redesign_line(label, name, B, ms_new, ms_prev, yard, bnd):
    """One line of a redesigned kernel's times; returns them for the JSON."""
    bms, by = bnd
    log(f"[{label}] B={B} {name} {ms_new:.4f} ms, {name}_prev {ms_prev:.4f} ms "
        f"({ms_prev / ms_new:.2f}x, in turns), bound {bms:.4f} ms ({by}, "
        f"{bms / ms_new:.0%} of it), baddbmm yardstick {yard:.4f} ms")
    return {"ms": ms_new, "witness_ms": ms_prev, "bound_ms": bms,
            "yardstick_ms": yard}


def minv_flops(n, m):
    """FLOPs of one M^{-1}-form iteration with REFINE passes: the rhs's
    A't (2mn), then per solve Minv r (2n^2) and per refinement pass A x,
    A'(.) (4mn) and P x (2n^2), then A xx (2mn); m = me + mi for prox."""
    return 2 * n * n * (1 + 2 * REFINE) + 4 * m * n * (1 + REFINE)


def minv_pair(torch, name, stream, cluster, plain, args, kw, nbytes, flops,
              out, failures):
    """Row 4b or 5b: the M^{-1}-form cluster kernel (``name``_cluster) beside
    the streaming kernel (``name``, its witness), each through its own
    wrapper: both against the plain version (LIMIT), the cluster's outputs
    bit for bit the streaming kernel's at K and at K=1, and both timed in
    turns (streaming, cluster, cluster, streaming). Records both entries in
    ``out`` and returns the streaming kernel's outputs."""
    ks = stream(*args, **kw)
    kc = cluster(*args, **kw)
    kp = plain(*args, **kw)
    err_s = compare(name, ks, kp, failures)
    err_c = compare(f"{name}_cluster", kc, kp, failures)
    for k, (a, b) in ((kw["K"], (kc, ks)),
                      (1, (cluster(*args, **dict(kw, K=1)),
                           stream(*args, **dict(kw, K=1))))):
        same = all(torch.equal(u, v) for u, v in zip(a, b))
        log(f"[phase 2] {name}_cluster (K={k}): every output bit for bit the "
            f"streaming kernel's: {same}")
        if not same:
            failures.append(f"{name}_cluster (K={k}): not the streaming "
                            "kernel's bits")
    ms_s, ms_c = in_turns(lambda: stream(*args, **kw),
                          lambda: cluster(*args, **kw))
    plain_ms = cuda_ms(lambda: plain(*args, **kw))
    bnd = bound(nbytes, flops)
    out[name] = (err_s, ms_s, plain_ms, None, bnd)
    out[f"{name}_cluster"] = (err_c, ms_c, plain_ms, None, bnd)
    log(f"[phase 2] {name}_cluster {ms_c:.4f} ms against the streaming "
        f"{name} {ms_s:.4f} ms ({ms_s / ms_c:.2f}x; B={args[0].shape[0]}, "
        f"K={kw['K']}, refine {kw['refine']}, in turns), bound {bnd[0]:.4f} "
        f"ms ({bnd[1]})")
    return ks


def phase_kernels(torch, extra):
    from quadraticprogramsolver_tpu_torch.ops import (
        fused_admm, fused_factor, fused_proxqp, linalg, spd_kernels)
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)
    from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
        device_prox_fleet)

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    qp = device_random_qp_fleet(B_KERNEL, N, M, generator=g)
    rho_row = torch.full((B_KERNEL, M), 0.4, device=DEVICE)
    sigma = 1e-6
    kp = fused_factor.slab_k(M)
    # name -> (max abs err, kernel ms, plain ms, library ms, (bound ms, by))
    out, failures = {}, []

    args = (qp.P, qp.A, qp.q, rho_row, sigma)
    Sk = fused_factor.build_slab(*args)
    Sp = fused_factor.build_slab_plain(*args)
    err_prev = compare("slab_build_prev", fused_factor.build_slab_prev(*args),
                       Sp, failures)
    yard = yardstick_ms(torch, B_KERNEL, N, M, kp + (N - 128), g)
    ms_new, ms_prev = build_pair(torch, args, "phase 2", failures)
    bnd = slab_build_bound(B_KERNEL, N, (M,))
    plain_ms = cuda_ms(lambda: fused_factor.build_slab_plain(*args))
    out["slab_build"] = (compare("slab_build", Sk, Sp, failures), ms_new,
                         plain_ms, None, bnd)
    out["slab_build_prev"] = (err_prev, ms_prev, plain_ms, None, bnd)
    extra["slab_build"] = redesign_line("phase 2", "slab_build", B_KERNEL,
                                        ms_new, ms_prev, yard["slab_build"], bnd)
    del Sk

    j = N // 128 - 1
    w_out = kp + j * 128
    D = Sp[:, j * 128:(j + 1) * 128, w_out:w_out + 128]
    Dk = spd_kernels.spd_inverse_unrolled(D)
    Dp = spd_kernels.pivot_sweep_v3_plain(D)
    Dprev = spd_kernels.pivot_sweep_v3_prev(D)
    # Row 2's kernel bit for bit its previous kernel, on the slab's pivot
    # blocks (read through the slab's strides) and on spread-diagonal blocks.
    for kind, Db in (("slab", D), ("spread", spread_blocks(torch, B_KERNEL, g))):
        same = torch.equal(spd_kernels.spd_inverse_unrolled(Db),
                           spd_kernels.pivot_sweep_v3_prev(Db))
        log(f"[phase 2] pivot_sweep_v3 ({kind} blocks): bit for bit equal to "
            f"pivot_sweep_v3_prev: {same}")
        if not same:
            failures.append(f"pivot_sweep_v3 ({kind} blocks): not the "
                            "previous kernel's bits")
    ms_prev, ms_new = in_turns(lambda: spd_kernels.pivot_sweep_v3_prev(D),
                               lambda: spd_kernels.spd_inverse_unrolled(D))
    plain_ms = cuda_ms(lambda: spd_kernels.pivot_sweep_v3_plain(D))
    lib_ms = cuda_ms(lambda: torch.linalg.inv(D))
    out["pivot_sweep_v3"] = (compare("pivot_sweep_v3", Dk, Dp, failures),
                             ms_new, plain_ms, lib_ms, pivot_bound(B_KERNEL))
    out["pivot_sweep_v3_prev"] = (compare("pivot_sweep_v3_prev", Dprev, Dp,
                                          failures),
                                  ms_prev, plain_ms, lib_ms,
                                  pivot_bound(B_KERNEL))
    log(f"[phase 2] pivot_sweep_v3 {ms_new:.4f} ms against "
        f"pivot_sweep_v3_prev {ms_prev:.4f} ms ({ms_prev / ms_new:.2f}x; "
        f"B={B_KERNEL}, in turns)")

    S1, S2 = Sp.clone(), Sp.clone()
    fused_factor.slab_level(S1, Dp, j, w_out)
    fused_factor.slab_level_plain(S2, Dp, j, w_out)
    err = compare("slab_level", S1[:, :, :w_out], S2[:, :, :w_out], failures)
    if not torch.equal(S1[:, :, w_out:], Sp[:, :, w_out:]):
        failures.append("slab_level wrote outside the live region")
    if torch.equal(S1[:, :, :w_out], Sp[:, :, :w_out]):
        failures.append("slab_level left the live region unchanged")
    fused_factor.slab_level_prev(S1.copy_(Sp), Dp, j, w_out)
    err_prev = compare("slab_level_prev", S1[:, :, :w_out], S2[:, :, :w_out],
                       failures)
    del S1, S2
    ms_new, ms_prev = level_pair(torch, Sp, Dp, j, w_out, "phase 2", failures)
    if ms_new > SIMT_STRIP_MS:
        failures.append(f"slab_level {ms_new:.4f} ms at B={B_KERNEL}: slower "
                        f"than the SIMT strip kernel it replaced "
                        f"({SIMT_STRIP_MS} ms)")
    bnd = level_bound(B_KERNEL, N, w_out)
    level_plain_ms = cuda_ms(lambda S: fused_factor.slab_level_plain(S, Dp, j, w_out),
                             setup=lambda: (Sp.clone(),))
    out["slab_level"] = (err, ms_new, level_plain_ms, None, bnd)
    out["slab_level_prev"] = (err_prev, ms_prev, level_plain_ms, None, bnd)
    extra["slab_level"] = redesign_line("phase 2", "slab_level", B_KERNEL,
                                        ms_new, ms_prev, yard["slab_level"], bnd)
    phase_factor_kernels(torch, D, Sp, Dp, j, w_out, g, out, extra, failures)
    phase_entry_kernels(torch, D, qp, out, extra, failures)
    del Sp, D, Dk, Dp

    S = fused_factor.fused_factor_solve(qp.P, qp.A, qp.q, rho_row, sigma=sigma)
    G, gv = S[..., :M].contiguous(), S[..., M].contiguous()
    x = torch.randn((B_KERNEL, N), generator=g, device=DEVICE)
    z = torch.randn((B_KERNEL, M), generator=g, device=DEVICE)
    y = torch.randn((B_KERNEL, M), generator=g, device=DEVICE)
    active = torch.arange(B_KERNEL, device=DEVICE) % 4 != 3
    n_act = int(active.sum())
    cargs = (G, qp.A, gv, qp.l, qp.u, x, z, y, rho_row, active)
    kw = dict(K=K_CHUNK, alpha=1.6)
    # Row 4a: the streaming kernel (every variant's) and the cluster kernel.
    stream, cluster = (fused_admm.fused_admm_chunk_streaming,
                       fused_admm.fused_admm_chunk_cluster)
    ck = stream(*cargs, **kw)
    cp = fused_admm.fused_admm_chunk_plain(*cargs, **kw)
    err = compare("admm_chunk", ck, cp, failures)
    frozen = ~active
    cc = cluster(*cargs, **kw)
    err_c = compare("admm_chunk_cluster", cc, cp, failures)
    for nm, o in (("admm_chunk", ck), ("admm_chunk_cluster", cc)):
        if not (torch.equal(o[0][frozen], x[frozen])
                and torch.equal(o[3][frozen], x[frozen])
                and torch.equal(o[4][frozen], z[frozen])):
            failures.append(f"{nm}: a frozen lane did not pass through")
    # Bit for bit, all seven outputs: from G and from the slab window, at
    # K = 11 and K = 1.
    for src, slab in (("G", False), ("slab", True)):
        for k in (K_CHUNK, 1):
            a = cluster(S if slab else G, *cargs[1:], K=k, alpha=1.6, slab=slab)
            b = ck if (k == K_CHUNK and not slab) else stream(*cargs, K=k, alpha=1.6)
            same = all(torch.equal(u_, v_) for u_, v_ in zip(a, b))
            log(f"[phase 2] admm_chunk_cluster ({src}, K={k}): seven outputs "
                f"bit for bit the streaming kernel's: {same}")
            if not same:
                failures.append(f"admm_chunk_cluster ({src}, K={k}): not the "
                                "streaming kernel's bits")
    # G for the active lanes, A for every lane (the check products), the
    # vectors in (g, x, l, u, rho, z, y) and out (x, xp, A'y, z, y, zp, Ax).
    admm_bytes = 4 * (n_act * N * M + B_KERNEL * M * N
                      + B_KERNEL * (2 * N + 5 * M) + B_KERNEL * (3 * N + 4 * M))
    admm_flops = 4 * N * M * (n_act * K_CHUNK + B_KERNEL)
    ms_s, ms_c = in_turns(lambda: stream(*cargs, **kw),
                          lambda: cluster(*cargs, **kw))
    admm_plain_ms = cuda_ms(lambda: fused_admm.fused_admm_chunk_plain(*cargs, **kw))
    out["admm_chunk"] = (err, ms_s, admm_plain_ms, None,
                         bound(admm_bytes, admm_flops))
    out["admm_chunk_cluster"] = (err_c, ms_c, admm_plain_ms, None,
                                 bound(admm_bytes, admm_flops))
    log(f"[phase 2] admm_chunk_cluster {ms_c:.4f} ms against the streaming "
        f"admm_chunk {ms_s:.4f} ms ({ms_s / ms_c:.2f}x; B={B_KERNEL}, "
        f"K={K_CHUNK}, in turns)")
    # Row 4c, the sigma-free variants. The iterate products of "high" are
    # three bf16 passes; the check products stay FP32 there and run at one
    # bf16 pass at "default". The bytes do not change: G read once (f32, or
    # two bf16 halves, or a window of the slab).
    vecs = (qp.l, qp.u, x, z, y, rho_row, active)
    it_flops, chk_flops = 4 * N * M * n_act * K_CHUNK, 4 * N * M * B_KERNEL
    hi_flops = (chk_flops, 3 * it_flops)
    admm_outs = ("x", "z", "y", "x_prev", "z_prev", "Ax", "ATy")
    run, run_plain = fused_admm.fused_admm_chunk, fused_admm.fused_admm_chunk_plain
    Ghi, Glo = linalg.bf16_split(G)
    wk = dict(stream_fn=stream, extra=extra)
    high = variant(out, failures, "admm_chunk_high", run, run_plain,
                   cargs, dict(kw, dot_precision="high"), admm_bytes, hi_flops,
                   witness_outs=admm_outs, **wk)
    variant(out, failures, "admm_chunk_default", run, run_plain, cargs,
            dict(kw, dot_precision="default"), admm_bytes, (0, admm_flops),
            witness_outs=admm_outs, **wk)
    default_check("admm_chunk_default", run, run_plain, cargs, kw, admm_outs,
                  failures)
    variant(out, failures, "admm_chunk_split", run, run_plain,
            (Ghi, qp.A, gv, *vecs), dict(kw, dot_precision="high", Glo=Glo),
            admm_bytes, hi_flops, same_as=high, **wk)
    variant(out, failures, "admm_chunk_slab", run, run_plain, (S, qp.A, gv, *vecs),
            dict(kw, dot_precision="high", slab=True), admm_bytes, hi_flops,
            same_as=high, **wk)
    variant(out, failures, "admm_chunk_lanes2", run, run_plain, cargs,
            dict(kw, dot_precision="high", lanes=2), admm_bytes, hi_flops,
            same_as=high, **wk)
    variant(out, failures, "admm_chunk_lanes4", run, run_plain, cargs,
            dict(kw, lanes=4), admm_bytes, (admm_flops, 0), same_as=ck,
            limit=True, **wk)
    del qp, S, G, gv, Ghi, Glo, cargs, ck, cp, high, rho_row

    # The prox family's shapes: the two-block build, then the prox chunk.
    prob = device_prox_fleet(B_KERNEL, N, ME, MI, generator=g)
    rho = 0.0125 * (1.0 + torch.rand(B_KERNEL, generator=g, device=DEVICE))
    rho_row = rho[:, None].expand(B_KERNEL, ME + MI).contiguous()
    blocks = (prob.A, prob.C)
    bargs = (prob.P, blocks, prob.q, rho_row, 0.0)
    Sk = fused_factor.build_slab(*bargs)
    Sp = fused_factor.build_slab_plain(*bargs)
    ms_new, ms_prev = build_pair(torch, bargs, "phase 2 two blocks", failures)
    out["slab_build_two_block"] = (
        compare("slab_build (two blocks)", Sk, Sp, failures), ms_new,
        cuda_ms(lambda: fused_factor.build_slab_plain(*bargs)),
        None, slab_build_bound(B_KERNEL, N, (ME, MI)))
    extra["slab_build"]["two_block_witness_ms"] = ms_prev
    del Sk, Sp
    S = fused_factor.fused_factor_solve(prob.P, blocks, prob.q, rho_row,
                                        sigma=0.0)
    mt = ME + MI
    G, gv = S[..., :mt].contiguous(), S[..., mt].contiguous()
    del S
    x = torch.randn((B_KERNEL, N), generator=g, device=DEVICE)
    s = torch.rand((B_KERNEL, MI), generator=g, device=DEVICE)
    y = torch.randn((B_KERNEL, ME), generator=g, device=DEVICE)
    z = torch.rand((B_KERNEL, MI), generator=g, device=DEVICE)
    pargs = (G, prob.A, prob.C, gv, prob.b, prob.d, x, s, y, z, rho, active)
    # Row 5a: the streaming kernel (every variant's) and the cluster kernel.
    pstream, pcluster = (fused_proxqp.fused_proxqp_chunk_streaming,
                         fused_proxqp.fused_proxqp_chunk_cluster)
    pk = pstream(*pargs, K=K_PROX)
    pp = fused_proxqp.fused_proxqp_chunk_plain(*pargs, K=K_PROX)
    err = compare("prox_chunk", pk, pp, failures)
    pc = pcluster(*pargs, K=K_PROX)
    err_pc = compare("prox_chunk_cluster", pc, pp, failures)
    for nm, o in (("prox_chunk", pk), ("prox_chunk_cluster", pc)):
        if not all(torch.equal(a[frozen], v[frozen])
                   for a, v in zip(o, (x, s, y, z))):
            failures.append(f"{nm}: a frozen lane did not pass through")
    # Bit for bit, all four outputs, at K = 25 and K = 1.
    for k in (K_PROX, 1):
        a = pc if k == K_PROX else pcluster(*pargs, K=k)
        b = pk if k == K_PROX else pstream(*pargs, K=k)
        same = all(torch.equal(u_, v_) for u_, v_ in zip(a, b))
        log(f"[phase 2] prox_chunk_cluster (K={k}): x, s, y, z bit for bit "
            f"the streaming kernel's: {same}")
        if not same:
            failures.append(f"prox_chunk_cluster (K={k}): not the streaming "
                            "kernel's bits")
    prox_bytes, prox_flops = prox_chunk_work(B_KERNEL, n_act, K_PROX)
    ms_ps, ms_pc = in_turns(lambda: pstream(*pargs, K=K_PROX),
                            lambda: pcluster(*pargs, K=K_PROX))
    prox_plain_ms = cuda_ms(
        lambda: fused_proxqp.fused_proxqp_chunk_plain(*pargs, K=K_PROX))
    out["prox_chunk"] = (err, ms_ps, prox_plain_ms, None,
                         bound(prox_bytes, prox_flops))
    out["prox_chunk_cluster"] = (err_pc, ms_pc, prox_plain_ms, None,
                                 bound(prox_bytes, prox_flops))
    log(f"[phase 2] prox_chunk_cluster {ms_pc:.4f} ms against the streaming "
        f"prox_chunk {ms_ps:.4f} ms ({ms_ps / ms_pc:.2f}x; B={B_KERNEL}, "
        f"K={K_PROX}, in turns)")
    # Row 5c: the prox variants ("high" runs G t, C x and A x as three bf16
    # passes, "default" as one).
    run, run_plain = fused_proxqp.fused_proxqp_chunk, fused_proxqp.fused_proxqp_chunk_plain
    wk = dict(stream_fn=pstream, extra=extra)
    high = variant(out, failures, "prox_chunk_high", run, run_plain, pargs,
                   dict(K=K_PROX, dot_precision="high"), prox_bytes,
                   (0, 3 * prox_flops), witness_outs="xsyz", **wk)
    variant(out, failures, "prox_chunk_default", run, run_plain, pargs,
            dict(K=K_PROX, dot_precision="default"), prox_bytes,
            (0, prox_flops), witness_outs="xsyz", **wk)
    default_check("prox_chunk_default", run, run_plain, pargs, dict(K=K_PROX),
                  "xsyz", failures)
    variant(out, failures, "prox_chunk_lanes2", run, run_plain, pargs,
            dict(K=K_PROX, dot_precision="high", lanes=2), prox_bytes,
            (0, 3 * prox_flops), same_as=high, **wk)
    del G, gv, pargs, pk, pp, pc, high

    # The M^{-1}-form prox chunk: M = P + sigma*I + rho(A'A + C'C).
    sigma_p = 1e-2
    Mn = prob.P + sigma_p * torch.eye(N, device=DEVICE) + rho[:, None, None] * (
        prob.A.transpose(1, 2) @ prob.A + prob.C.transpose(1, 2) @ prob.C)
    Minv = linalg.spd_inverse(Mn)
    del Mn
    qargs = (Minv, prob.A, prob.C, prob.P, prob.q, prob.b, prob.d, x, s, y, z,
             rho, active)
    qkw = dict(K=K_MINV, sigma=sigma_p, refine=REFINE)
    qbytes, qflops = prox_minv_work(B_KERNEL, n_act)
    # Row 5b: the cluster kernel beside the streaming one (its witness).
    qk = minv_pair(torch, "prox_chunk_minv",
                   fused_proxqp.fused_proxqp_chunk_minv_streaming,
                   fused_proxqp.fused_proxqp_chunk_minv_cluster,
                   fused_proxqp.fused_proxqp_chunk_minv_plain, qargs, qkw,
                   qbytes, qflops, out, failures)
    if not all(torch.equal(o[frozen], v[frozen])
               for o, v in zip(qk, (x, s, y, z))):
        failures.append("prox_chunk_minv: a frozen lane did not pass through")
    variant(out, failures, "prox_chunk_minv_lanes2",
            fused_proxqp.fused_proxqp_chunk_minv,
            fused_proxqp.fused_proxqp_chunk_minv_plain, qargs,
            dict(qkw, lanes=2), qbytes, (qflops, 0), same_as=qk, limit=True,
            stream_fn=fused_proxqp.fused_proxqp_chunk_minv_streaming,
            extra=extra)
    del Minv, qargs, qk
    # The f64 witness at these penalties and at 7c's starting rho0 = 0.1.
    for rho_w, tag in ((rho, "rho 0.0125-0.025"),
                       (torch.full_like(rho, 0.1), "rho 0.1")):
        prox_minv_witness(torch, prob, rho_w, (x, s, y, z), active,
                          f"phase 2 witness, {tag}", failures)
    del prob

    # The M^{-1}-form ADMM chunk: M = P + sigma*I + A' diag(rho) A, the f32
    # floor of sigma.
    qp = device_random_qp_fleet(B_KERNEL, N, M, generator=g)
    rho_row = torch.full((B_KERNEL, M), 0.4, device=DEVICE)
    sigma_a = 1e-4
    Mn = qp.P + sigma_a * torch.eye(N, device=DEVICE) + (
        qp.A.transpose(1, 2) * rho_row[:, None, :]) @ qp.A
    Minv = linalg.spd_inverse(Mn)
    del Mn
    x = torch.randn((B_KERNEL, N), generator=g, device=DEVICE)
    z = torch.randn((B_KERNEL, M), generator=g, device=DEVICE)
    y = torch.randn((B_KERNEL, M), generator=g, device=DEVICE)
    margs = (Minv, qp.A, qp.P, qp.q, qp.l, qp.u, x, z, y, rho_row, active)
    mkw = dict(K=K_MINV, alpha=1.6, sigma=sigma_a, refine=REFINE)
    mbytes, mflops = admm_minv_work(B_KERNEL, n_act)
    # Row 4b: the cluster kernel beside the streaming one (its witness).
    mk = minv_pair(torch, "admm_chunk_minv",
                   fused_admm.fused_admm_chunk_minv_streaming,
                   fused_admm.fused_admm_chunk_minv_cluster,
                   fused_admm.fused_admm_chunk_minv_plain, margs, mkw, mbytes,
                   mflops, out, failures)
    if not (torch.equal(mk[0][frozen], x[frozen])
            and torch.equal(mk[3][frozen], x[frozen])
            and torch.equal(mk[4][frozen], z[frozen])):
        failures.append("admm_chunk_minv: a frozen lane did not pass through")
    variant(out, failures, "admm_chunk_minv_lanes2",
            fused_admm.fused_admm_chunk_minv,
            fused_admm.fused_admm_chunk_minv_plain, margs, dict(mkw, lanes=2),
            mbytes, (mflops, 0), same_as=mk, limit=True,
            stream_fn=fused_admm.fused_admm_chunk_minv_streaming, extra=extra)
    witness("phase 2 witness, rho 0.4", "admm_chunk_minv_cluster",
            fused_admm.fused_admm_chunk_minv_cluster,
            fused_admm.fused_admm_chunk_minv_plain, margs, mkw,
            ("x", "z", "y", "x_prev", "z_prev", "Ax", "ATy"), failures)
    for name, (e, ms, pms, lms, (bms, by)) in out.items():
        lib = "none" if lms is None else f"{lms:.4f} ms"
        log(f"[phase 2] {name}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
            f"library {lib}, bound {bms:.4f} ms ({by}) (B={B_KERNEL}, "
            f"median of 5)")
    require(not failures, "; ".join(failures))
    return out


def in_turns(old, new, timer=None):
    """(old ms, new ms): each timed twice in turns (old, new, new, old) by
    ``timer`` (cuda_ms, the median of 5, by default), the median of its
    two times."""
    timer = timer or cuda_ms
    t_old, t_new = [timer(old)], [timer(new)]
    t_new.append(timer(new))
    t_old.append(timer(old))
    return statistics.median(t_old), statistics.median(t_new)


def admm_chunk_bound(B, n_act, K):
    """The sigma-free chunk's bound: G for the active lanes, A for every
    lane (the check products), the vectors in (g, x, l, u, rho, z, y) and out
    (x, xp, A'y, z, y, zp, Ax); 4nm FLOPs a lane and iteration, and 4nm a
    lane for the check products."""
    nbytes = 4 * (n_act * N * M + B * M * N + B * (2 * N + 5 * M)
                  + B * (3 * N + 4 * M))
    return bound(nbytes, 4 * N * M * (n_act * K + B))


def variant_pairs(torch, stream, cluster, occupancy, cases, args_of, kw, highest,
                  work, failures, res):
    """Phase 2b, rows 4c and 5c: each cluster variant (``cases``: name ->
    (G source, keyword arguments)) of the one-kernel wrapper ``cluster``
    beside ``stream``, the streaming kernel of the same variant (its
    witness), at B=512 and B_REDESIGN with every lane active: bit for bit,
    timed in turns (old, new, new, old), beside its bound (``work(b, kw)``
    -> (bytes, FP32 FLOPs, bf16 FLOPs)) and the "highest" cluster kernel's
    time at that B (``highest``: tag -> ms), with the clusters resident at
    once (``occupancy(precision)``); at B_REDESIGN also what an iteration
    costs a cluster (from K=1 against kw's K), the "highest" kernel's
    beside it."""
    K = kw["K"]

    def iteration_us(ms, ms_k1, resident):
        return (ms - ms_k1) / (K - 1) / (B_REDESIGN / resident) * 1e3

    base = args_of("G")
    top_k1 = cuda_ms(lambda: cluster(*base, **dict(kw, K=1)))
    top_us = iteration_us(highest[f"b{B_REDESIGN}"], top_k1, occupancy("highest"))
    for name, (src, vkw) in cases.items():
        args, k = args_of(src), dict(kw, **vkw)
        resident = occupancy(k.get("dot_precision", "highest"))
        ref = stream(*args, **k)
        for b in (B_KERNEL, B_REDESIGN):
            sub = tuple(a[:b] for a in args)
            kb = {key: v[:b] if torch.is_tensor(v) else v for key, v in k.items()}
            bms, by = bound(*work(b, k))
            ms_s, ms_c = in_turns(lambda: stream(*sub, **kb),
                                  lambda: cluster(*sub, **kb))
            same = all(torch.equal(u_, v_[:b])
                       for u_, v_ in zip(cluster(*sub, **kb), ref))
            if not same:
                failures.append(f"phase 2b: {name} (B={b}) is not the "
                                "streaming kernel's bits")
            tag = f"b{b}" if b != B_KERNEL else "b512_all_active"
            log(f"[phase 2b] B={b} {name} (every lane active): cluster "
                f"{ms_c:.4f} ms, streaming {ms_s:.4f} ms ({ms_s / ms_c:.2f}x); "
                f"\"highest\" cluster {highest[tag]:.4f} ms; bound {bms:.4f} ms "
                f"({by}); {resident} clusters resident; bit for bit: {same}")
            res.setdefault(name, {})[tag] = {
                "ms": ms_c, "stream_ms": ms_s, "highest_cluster_ms": highest[tag],
                "bound_ms": bms}
        ms_k1 = cuda_ms(lambda: cluster(*args, **dict(k, K=1)))
        it_us = iteration_us(res[name][f"b{B_REDESIGN}"]["ms"], ms_k1, resident)
        log(f"[phase 2b] B={B_REDESIGN} {name}: K=1 {ms_k1:.4f} ms; a cluster's "
            f"iteration {it_us:.3f} us against \"highest\"'s {top_us:.3f} us "
            f"(K=1 {top_k1:.4f} ms)")
        res[name][f"b{B_REDESIGN}"].update(k1_ms=ms_k1, iteration_us=it_us,
                                           highest_iteration_us=top_us)
        res[name]["clusters_resident"] = resident


def admm_variant_work(b, kw):
    """(bytes, FP32 FLOPs, bf16 FLOPs) of a sigma-free ADMM variant at B=b,
    K_CHUNK, every lane active: admm_chunk_bound's bytes; "high" runs its
    iterate products as three bf16 passes and its check products in FP32,
    "default" all of them as one bf16 pass."""
    nbytes = 4 * (b * N * M + b * M * N + b * (2 * N + 5 * M) + b * (3 * N + 4 * M))
    it, chk = 4 * N * M * b * K_CHUNK, 4 * N * M * b
    if kw.get("dot_precision") == "high":
        return nbytes, chk, 3 * it
    return nbytes, 0, it + chk


def prox_variant_work(b, kw):
    """(bytes, FP32 FLOPs, bf16 FLOPs) of a sigma-free prox variant at B=b,
    K_PROX, every lane active: three bf16 passes at "high", one at
    "default" (no product stays FP32)."""
    nbytes, flops = prox_chunk_work(b, b, K_PROX)
    return nbytes, 0, (3 if kw.get("dot_precision") == "high" else 1) * flops


def admm_minv_work(B, n_act):
    """The M^{-1}-form ADMM chunk's least work at K_MINV, REFINE: Minv and P
    of the active lanes and A of every lane (the check products) read once,
    the vectors in (q, x, l, u, rho, z, y) and out (x, xp, A'y, z, y, zp,
    Ax); minv_flops a lane and iteration, 4nm a lane for the check
    products. Returns (bytes, FP32 FLOPs)."""
    nbytes = 4 * (n_act * 2 * N * N + B * M * N + B * (2 * N + 5 * M)
                  + B * (3 * N + 4 * M))
    return nbytes, n_act * K_MINV * minv_flops(N, M) + B * 4 * N * M


def prox_minv_work(B, n_act):
    """The M^{-1}-form prox chunk's least work at K_MINV, REFINE: Minv, P,
    A and C of the active lanes read once, the vectors in (q, x, b, y, d,
    s, z, rho, active) and out (x, y, s, z); minv_flops a lane and
    iteration. Returns (bytes, FP32 FLOPs)."""
    mt = ME + MI
    nbytes = 4 * (n_act * (2 * N * N + mt * N) + B * (2 * N + 2 * ME + 3 * MI + 2)
                  + B * (N + ME + 2 * MI))
    return nbytes, n_act * K_MINV * minv_flops(N, mt)


def prox_chunk_work(B, n_act, K):
    """The sigma-free prox chunk's least work: G, A and C read once for the
    active lanes, the vectors in (g, x, b, y, d, s, z, rho, active) and out
    (x, y, s, z); 4 n (me + mi) FLOPs a lane and iteration. Returns (bytes,
    FP32 FLOPs)."""
    mt = ME + MI
    nbytes = 4 * (n_act * (N * mt + mt * N) + B * (2 * N + 2 * ME + 3 * MI + 2)
                  + B * (N + ME + 2 * MI))
    return nbytes, n_act * K * 4 * N * mt


def phase_redesigns(torch):
    """Phase 2b: rows 2, 4a and 5a at the main path's B=4096 beside their
    previous kernels: the pivot sweep on the fleet's last pivot blocks (read
    through the slab's strides; rows 6 and 7, the unscaled sweeps, on the
    same blocks, and rows 9 and 10, the group sweeps, there and on their
    first 512; row 3b, the bf16x3 level, on the slab at j=3, at B=512 and
    4096), the sigma-free ADMM chunk (K=11) and the
    sigma-free prox chunk (K=25, phase 6's shape) from their factors, every
    lane active, each bit for bit its witness and timed in turns, at B=512
    and B=4096; each cluster chunk's clusters resident at once
    (cudaOccupancyMaxActiveClusters); then rows 4c and 5c, each cluster
    variant ("high" and "default" from G, "high" from the bf16 halves and
    the slab window; prox "high" and "default") beside the streaming
    kernel of the same variant (``variant_pairs``). Returns each kernel's
    numbers for the kernels JSON."""
    from quadraticprogramsolver_tpu_torch.ops import (
        fused_admm, fused_factor, fused_proxqp, linalg, spd_kernels)
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)
    from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
        device_prox_fleet)

    B, failures, res = B_REDESIGN, [], {}
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    qp = device_random_qp_fleet(B, N, M, generator=g)
    rho = torch.full((B, M), 0.4, device=DEVICE)
    j = N // 128 - 1
    w_out = fused_factor.slab_k(M) + j * 128
    # Rows 1 and 3: the triangle build and the strip level.
    yard = yardstick_ms(torch, B, N, M, w_out, g)
    args = (qp.P, qp.A, qp.q, rho, 1e-6)
    ms_new, ms_prev = build_pair(torch, args, "phase 2b", failures)
    bnd = slab_build_bound(B, N, (M,))
    res["slab_build"] = {"b4096": redesign_line(
        "phase 2b", "slab_build", B, ms_new, ms_prev, yard["slab_build"], bnd)}
    res["slab_build_prev"] = {"b4096": {"ms": ms_prev, "bound_ms": bnd[0]}}
    Sp = fused_factor.build_slab(*args)
    D = Sp[:, j * 128:(j + 1) * 128, w_out:w_out + 128]
    Dinv = spd_kernels.spd_inverse_unrolled(D)
    ms_new, ms_prev = level_pair(torch, Sp, Dinv, j, w_out, "phase 2b", failures)
    bnd = level_bound(B, N, w_out)
    res["slab_level"] = {"b4096": redesign_line(
        "phase 2b", "slab_level", B, ms_new, ms_prev, yard["slab_level"], bnd)}
    res["slab_level_prev"] = {"b4096": {"ms": ms_prev, "bound_ms": bnd[0]}}
    new, prev = spd_kernels.spd_inverse_unrolled, spd_kernels.pivot_sweep_v3_prev
    same = torch.equal(new(D), prev(D))
    ms_prev, ms_new = in_turns(lambda: prev(D), lambda: new(D))
    bms, by = pivot_bound(B)
    log(f"[phase 2b] B={B} pivot_sweep_v3 {ms_new:.4f} ms, pivot_sweep_v3_prev "
        f"{ms_prev:.4f} ms ({ms_prev / ms_new:.2f}x), bound {bms:.4f} ms "
        f"({by}); bit for bit: {same}")
    if not same:
        failures.append(f"phase 2b: pivot_sweep_v3 at B={B} not the previous "
                        "kernel's bits")
    res["pivot_sweep_v3"] = {"b4096": {"ms": ms_new, "bound_ms": bms}}
    res["pivot_sweep_v3_prev"] = {"b4096": {"ms": ms_prev, "bound_ms": bms}}
    # Rows 6 and 7 (the unscaled sweeps) on the same blocks.
    for name, new_fn, prev_fn in (
            ("pivot_sweep_2d", spd_kernels.spd_inverse_nb,
             spd_kernels.pivot_sweep_2d_prev),
            ("pivot_sweep_ref",
             lambda x: spd_kernels.spd_inverse_unrolled(x, variant="ref"),
             spd_kernels.pivot_sweep_ref_prev)):
        ms_new, ms_prev = sweep_pair(torch, "phase 2b", name, new_fn, prev_fn,
                                     {"slab": D}, failures)
        res[name] = {"b4096": {"ms": ms_new, "witness_ms": ms_prev,
                               "bound_ms": bms}}
        res[f"{name}_prev"] = {"b4096": {"ms": ms_prev, "bound_ms": bms}}
    knob_redesigns(torch, Sp, D, Dinv, j, w_out, (B_KERNEL, B), failures, res)
    paired_redesign(torch, D, g, failures, res)
    del Sp, D, Dinv

    S = fused_factor.fused_factor_solve(qp.P, qp.A, qp.q, rho, sigma=1e-6)
    G, gv = S[..., :M].contiguous(), S[..., M].contiguous()
    x, z, y = (torch.randn((B, w), generator=g, device=DEVICE)
               for w in (N, M, M))
    act = torch.ones(B, dtype=torch.bool, device=DEVICE)
    cargs = (G, qp.A, gv, qp.l, qp.u, x, z, y, rho, act)
    kw = dict(K=K_CHUNK, alpha=1.6)
    stream, cluster = (fused_admm.fused_admm_chunk_streaming,
                       fused_admm.fused_admm_chunk_cluster)
    ref = stream(*cargs, **kw)
    resident = fused_admm.cluster_occupancy(N, M)
    log(f"[phase 2b] cluster chunk at n={N}, m={M}: {resident} clusters of "
        f"{fused_admm.CLUSTER} CTAs resident at once, shared memory a CTA "
        f"{fused_admm.cluster_smem_bytes(N, M)} bytes")
    for b in (B_KERNEL, B):
        sub = tuple(a[:b] for a in cargs)
        bms, by = admm_chunk_bound(b, b, K_CHUNK)
        ms_s, ms_c = in_turns(lambda: stream(*sub, **kw),
                              lambda: cluster(*sub, **kw))
        same = all(torch.equal(u_, v_[:b])
                   for u_, v_ in zip(cluster(*sub, **kw), ref))
        if not same:
            failures.append(f"phase 2b: the cluster chunk (B={b}) is not the "
                            "streaming kernel's bits")
        log(f"[phase 2b] B={b} sigma-free chunk (K={K_CHUNK}, every lane "
            f"active): cluster {ms_c:.4f} ms, streaming {ms_s:.4f} ms "
            f"({ms_s / ms_c:.2f}x); bound {bms:.4f} ms ({by}); bit for bit: "
            f"{same}")
        tag = f"b{b}" if b != B_KERNEL else "b512_all_active"
        res.setdefault("admm_chunk", {})[tag] = {"ms": ms_s, "bound_ms": bms}
        res.setdefault("admm_chunk_cluster", {})[tag] = {"ms": ms_c,
                                                         "bound_ms": bms}
    res["admm_chunk_cluster"]["clusters_resident"] = resident
    highest = {t: v["ms"] for t, v in res["admm_chunk_cluster"].items()
               if isinstance(v, dict)}
    Ghi, Glo = linalg.bf16_split(G)
    variant_pairs(
        torch, stream, cluster, lambda prec: fused_admm.cluster_occupancy(N, M, prec),
        {"admm_chunk_high": ("G", dict(dot_precision="high")),
         "admm_chunk_default": ("G", dict(dot_precision="default")),
         "admm_chunk_split": ("split", dict(dot_precision="high", Glo=Glo)),
         "admm_chunk_slab": ("slab", dict(dot_precision="high", slab=True))},
        lambda src: ({"G": G, "split": Ghi, "slab": S}[src], *cargs[1:]), kw,
        highest, admm_variant_work, failures, res)
    del qp, S, G, gv, Ghi, Glo, cargs, ref

    prob = device_prox_fleet(B, N, ME, MI, generator=g)
    r = 0.0125 * (1.0 + torch.rand(B, generator=g, device=DEVICE))
    bargs = (prob.P, (prob.A, prob.C), prob.q,
             r[:, None].expand(B, ME + MI).contiguous(), 0.0)
    ms_new, ms_prev = build_pair(torch, bargs, "phase 2b two blocks", failures)
    bms, by = slab_build_bound(B, N, (ME, MI))
    log(f"[phase 2b] B={B} slab_build (two blocks) {ms_new:.4f} ms, "
        f"slab_build_prev {ms_prev:.4f} ms ({ms_prev / ms_new:.2f}x, in turns), "
        f"bound {bms:.4f} ms ({by})")
    res["slab_build"]["b4096_two_block"] = {"ms": ms_new, "witness_ms": ms_prev,
                                            "bound_ms": bms}
    S = fused_factor.fused_factor_solve(*bargs[:4], sigma=0.0)
    G, gv = S[..., :ME + MI].contiguous(), S[..., ME + MI].contiguous()
    del S
    it = (torch.randn((B, N), generator=g, device=DEVICE),
          torch.rand((B, MI), generator=g, device=DEVICE),
          torch.randn((B, ME), generator=g, device=DEVICE),
          torch.rand((B, MI), generator=g, device=DEVICE))
    pargs = (G, prob.A, prob.C, gv, prob.b, prob.d, *it, r, act)
    stream, cluster = (fused_proxqp.fused_proxqp_chunk_streaming,
                       fused_proxqp.fused_proxqp_chunk_cluster)
    ref = stream(*pargs, K=K_PROX)
    resident = fused_proxqp.cluster_occupancy(N, ME, MI)
    log(f"[phase 2b] prox cluster chunk at n={N}, me={ME}, mi={MI}: "
        f"{resident} clusters of {fused_proxqp.CLUSTER} CTAs resident at "
        f"once, shared memory a CTA "
        f"{fused_proxqp.cluster_smem_bytes(N, ME, MI)} bytes")
    for b in (B_KERNEL, B):
        sub = tuple(a[:b] for a in pargs)
        bms, by = bound(*prox_chunk_work(b, b, K_PROX))
        ms_s, ms_c = in_turns(lambda: stream(*sub, K=K_PROX),
                              lambda: cluster(*sub, K=K_PROX))
        same = all(torch.equal(u_, v_[:b])
                   for u_, v_ in zip(cluster(*sub, K=K_PROX), ref))
        if not same:
            failures.append(f"phase 2b: the prox cluster chunk (B={b}) is "
                            "not the streaming kernel's bits")
        log(f"[phase 2b] B={b} sigma-free prox chunk (K={K_PROX}, every lane "
            f"active): cluster {ms_c:.4f} ms, streaming {ms_s:.4f} ms "
            f"({ms_s / ms_c:.2f}x); bound {bms:.4f} ms ({by}); bit for bit: "
            f"{same}")
        tag = f"b{b}" if b != B_KERNEL else "b512_all_active"
        res.setdefault("prox_chunk", {})[tag] = {"ms": ms_s, "bound_ms": bms}
        res.setdefault("prox_chunk_cluster", {})[tag] = {"ms": ms_c,
                                                         "bound_ms": bms}
    res["prox_chunk_cluster"]["clusters_resident"] = resident
    highest = {t: v["ms"] for t, v in res["prox_chunk_cluster"].items()
               if isinstance(v, dict)}
    variant_pairs(
        torch, stream, cluster,
        lambda prec: fused_proxqp.cluster_occupancy(N, ME, MI, prec),
        {"prox_chunk_high": ("G", dict(dot_precision="high")),
         "prox_chunk_default": ("G", dict(dot_precision="default"))},
        lambda src: pargs, dict(K=K_PROX), highest, prox_variant_work,
        failures, res)
    del prob, G, gv, pargs, ref, it
    for name, numbers in minv_redesigns(torch, failures).items():
        res.setdefault(name, {}).update(numbers)
    require(not failures, "; ".join(failures))
    return res


def knob_redesigns(torch, Sp, D, Dinv, j, w_out, sizes, failures, res):
    """Phase 2b, rows 3b, 9 and 10 at each B of ``sizes`` (the first B lanes
    of the slab ``Sp``, its pivot blocks ``D`` at level ``j`` and their
    inverses ``Dinv``, every lane active): the bf16x3 strip level beside the
    two-launch bf16x3 level, and each group formulation (GROUP_VARIANTS)
    beside ``pivot_sweep_group_prev``, bit for bit and timed in turns;
    their numbers go into ``res`` under "b<B>"."""
    from quadraticprogramsolver_tpu_torch.ops import spd_kernels

    n = Sp.shape[1]
    for b in sizes:
        tag = f"b{b}"
        ms_new, ms_prev = level_pair(torch, Sp[:b], Dinv[:b], j, w_out,
                                     "phase 2b", failures, "high")
        bms, by = level_bound(b, n, w_out, "high")
        log(f"[phase 2b] B={b} slab_level_high {ms_new:.4f} ms, two-launch "
            f"witness {ms_prev:.4f} ms ({ms_prev / ms_new:.2f}x, in turns), "
            f"bound {bms:.4f} ms ({by}, {bms / ms_new:.0%} of it)")
        res.setdefault("slab_level_high", {})[tag] = {
            "ms": ms_new, "witness_ms": ms_prev, "bound_ms": bms}
        bms, by = pivot_bound(b)
        for variant in GROUP_VARIANTS:
            name = f"pivot_sweep_{variant}"
            ms_new, ms_prev = sweep_pair(
                torch, "phase 2b", name,
                lambda x, v=variant: spd_kernels.spd_inverse_unrolled(x, variant=v),
                lambda x, v=variant: spd_kernels.pivot_sweep_group_prev(x, v),
                {"slab": D[:b]}, failures)
            log(f"[phase 2b] B={b} {name}: bound {bms:.4f} ms ({by}, "
                f"{bms / ms_new:.0%} of it)")
            res.setdefault(name, {})[tag] = {"ms": ms_new, "witness_ms": ms_prev,
                                             "bound_ms": bms}
            res.setdefault("pivot_sweep_group_prev", {})[f"{variant}_{tag}"] = {
                "ms": ms_prev, "bound_ms": bms}


def paired_redesign(torch, D, g, failures, res):
    """Phase 2b, row 11 at each B of B_PAIRED: the paired-64 sweep beside
    its witness (``pivot_sweep_v3p_prev``), bit for bit on the leading
    64-blocks of the slab's pivot blocks ``D`` (read through the slab's
    strides), on spread-diagonal 64-blocks and on gram 64-blocks (the
    leading blocks of phase 10a's Dm'Dm/128 + 0.05 I), then both timed in
    turns on the device alone on copies of the slab's blocks (from memory,
    ``sweep_pair(cold=True)``), beside the byte bound;
    the numbers go into ``res`` under "b<B>". Then the Schur inverse's time
    split (``schur_split``) on the first B_PROBE gram 128-blocks, phase
    10a's shape (its own traced call stays away from phase 10c's traces,
    which a trace just before them can rob of their first kernels)."""
    from quadraticprogramsolver_tpu_torch.ops import spd_kernels

    top = max(B_PAIRED)
    spread = spread_blocks(torch, top, g)[:, :64, :64]
    Dm = torch.randn((top, 128, 128), generator=g, device=DEVICE)
    big = Dm.transpose(1, 2) @ Dm / 128 + 0.05 * torch.eye(128, device=DEVICE)
    gram = big[:, :64, :64]
    del Dm
    for b in B_PAIRED:
        blocks = {"slab": D[:b, :64, :64], "spread": spread[:b], "gram": gram[:b]}
        ms_new, ms_prev = sweep_pair(
            torch, "phase 2b", "pivot_sweep_v3p", spd_kernels.spd_inverse_64p,
            spd_kernels.pivot_sweep_v3p_prev, blocks, failures, cold=True)
        bms, by = bound(4 * 2 * b * 64 * 64, b * 64 ** 3)
        log(f"[phase 2b] B={b} pivot_sweep_v3p: bound {bms:.4f} ms ({by}, "
            f"{bms / ms_new:.0%} of it; the witness {bms / ms_prev:.0%})")
        res.setdefault("pivot_sweep_v3p", {})[f"b{b}"] = {
            "ms": ms_new, "witness_ms": ms_prev, "bound_ms": bms}
        res.setdefault("pivot_sweep_v3p_prev", {})[f"b{b}"] = {
            "ms": ms_prev, "bound_ms": bms}
    res["pivot_sweep_v3p"][f"b{B_PROBE}_schur"] = schur_split(
        torch, big[:B_PROBE], "phase 2b")


def minv_redesigns(torch, failures):
    """Phase 2b, rows 4b and 5b: each M^{-1}-form cluster chunk beside its
    streaming witness at B=512 and at 7b's and 7c's B_DEFAULTS=2048, K_MINV
    iterations, REFINE passes, every lane active (phase 2's penalties):
    bit for bit, timed in turns, beside its bound, with the clusters
    resident at once. Returns each kernel's numbers by B."""
    from quadraticprogramsolver_tpu_torch.ops import fused_admm, fused_proxqp, linalg
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)
    from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
        device_prox_fleet)

    B, res = B_DEFAULTS, {}

    def pair(name, stream, cluster, args, kw, work, resident):
        log(f"[phase 2b] {name}_cluster at n={N}: {resident} clusters of 8 "
            f"CTAs resident at once (refine {REFINE})")
        ref = stream(*args, **kw)
        for b in (B_KERNEL, B):
            sub = tuple(a[:b] for a in args)
            bms, by = bound(*work(b, b))
            ms_s, ms_c = in_turns(lambda: stream(*sub, **kw),
                                  lambda: cluster(*sub, **kw))
            same = all(torch.equal(u_, v_[:b])
                       for u_, v_ in zip(cluster(*sub, **kw), ref))
            if not same:
                failures.append(f"phase 2b: {name}_cluster (B={b}) is not the "
                                "streaming kernel's bits")
            log(f"[phase 2b] B={b} {name} (K={K_MINV}, refine {REFINE}, every "
                f"lane active): cluster {ms_c:.4f} ms, streaming {ms_s:.4f} ms "
                f"({ms_s / ms_c:.2f}x); bound {bms:.4f} ms ({by}); bit for bit: "
                f"{same}")
            tag = f"b{b}" if b != B_KERNEL else "b512_all_active"
            res.setdefault(name, {})[tag] = {"ms": ms_s, "bound_ms": bms}
            res.setdefault(f"{name}_cluster", {})[tag] = {"ms": ms_c,
                                                          "bound_ms": bms}
        # What sets the cluster kernel's time at B: a lane's fixed cost
        # (its matrices' loads, the epilogue) from K=1, an iteration's from
        # K=25 against K=1, a refinement pass's from refine 0 against
        # REFINE; each cluster walks B / resident lanes.
        ms_k1 = cuda_ms(lambda: cluster(*args, **dict(kw, K=1)))
        ms_r0 = cuda_ms(lambda: cluster(*args, **dict(kw, refine=0)))
        lanes = B / resident
        it_us = (ms_c - ms_k1) / (K_MINV - 1) / lanes * 1e3
        log(f"[phase 2b] B={B} {name}_cluster: K=1 {ms_k1:.4f} ms, refine 0 "
            f"{ms_r0:.4f} ms; a cluster's lane {ms_k1 / lanes * 1e3:.2f} us "
            f"fixed + {it_us:.2f} us an iteration (refine {REFINE}), of which "
            f"{(ms_c - ms_r0) / K_MINV / lanes * 1e3:.2f} us the refinement "
            f"pass")
        res[f"{name}_cluster"][f"b{B}"].update(k1_ms=ms_k1, refine0_ms=ms_r0,
                                               iteration_us=it_us)
        res[f"{name}_cluster"]["clusters_resident"] = resident

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    act = torch.ones(B, dtype=torch.bool, device=DEVICE)
    qp = device_random_qp_fleet(B, N, M, generator=g)
    rho_row = torch.full((B, M), 0.4, device=DEVICE)
    Mn = qp.P + 1e-4 * torch.eye(N, device=DEVICE) + (
        qp.A.transpose(1, 2) * rho_row[:, None, :]) @ qp.A
    Minv = linalg.spd_inverse(Mn)
    del Mn
    x, z, y = (torch.randn((B, w), generator=g, device=DEVICE)
               for w in (N, M, M))
    pair("admm_chunk_minv", fused_admm.fused_admm_chunk_minv_streaming,
         fused_admm.fused_admm_chunk_minv_cluster,
         (Minv, qp.A, qp.P, qp.q, qp.l, qp.u, x, z, y, rho_row, act),
         dict(K=K_MINV, alpha=1.6, sigma=1e-4, refine=REFINE), admm_minv_work,
         fused_admm.minv_cluster_occupancy(N, M, REFINE))
    del qp, Minv, x, z, y, rho_row

    prob = device_prox_fleet(B, N, ME, MI, generator=g)
    rho = 0.0125 * (1.0 + torch.rand(B, generator=g, device=DEVICE))
    Mn = prob.P + 1e-2 * torch.eye(N, device=DEVICE) + rho[:, None, None] * (
        prob.A.transpose(1, 2) @ prob.A + prob.C.transpose(1, 2) @ prob.C)
    Minv = linalg.spd_inverse(Mn)
    del Mn
    it = (torch.randn((B, N), generator=g, device=DEVICE),
          torch.rand((B, MI), generator=g, device=DEVICE),
          torch.randn((B, ME), generator=g, device=DEVICE),
          torch.rand((B, MI), generator=g, device=DEVICE))
    pair("prox_chunk_minv", fused_proxqp.fused_proxqp_chunk_minv_streaming,
         fused_proxqp.fused_proxqp_chunk_minv_cluster,
         (Minv, prob.A, prob.C, prob.P, prob.q, prob.b, prob.d, *it, rho, act),
         dict(K=K_MINV, sigma=1e-2, refine=REFINE), prox_minv_work,
         fused_proxqp.minv_cluster_occupancy(N, ME, MI, REFINE))
    return res


def time_chunks(torch):
    """``--time-chunks``: the sigma-free chunks and their variants at the
    main path's shapes (B=4096, every lane active; ADMM n=512, m=256, K=11
    from its slab; prox n=512, me = mi = 128, K=25), kernel ms (median of
    5, CUDA events); the variants through the solver's dispatch (the
    cluster chunks at every one of them)."""
    from quadraticprogramsolver_tpu_torch.ops import (
        fused_admm, fused_factor, fused_proxqp, linalg)
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)
    from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
        device_prox_fleet)

    def show(name, fn):
        log(f"[phase 2 B={B_MAIN}] {name}: kernel {cuda_ms(fn):.4f} ms "
            "(every lane active, median of 5)")

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    qp = device_random_qp_fleet(B_MAIN, N, M, generator=g)
    rho = torch.full((B_MAIN, M), 0.4, device=DEVICE)
    S = fused_factor.fused_factor_solve(qp.P, qp.A, qp.q, rho, sigma=1e-6)
    G, gv = S[..., :M].contiguous(), S[..., M].contiguous()
    Ghi, Glo = linalg.bf16_split(G)
    x, z, y = (torch.randn((B_MAIN, w), generator=g, device=DEVICE)
               for w in (N, M, M))
    act = torch.ones(B_MAIN, dtype=torch.bool, device=DEVICE)
    vecs = (qp.l, qp.u, x, z, y, rho, act)
    show("admm_chunk_cluster", lambda: fused_admm.fused_admm_chunk_cluster(
        G, qp.A, gv, *vecs, K=K_CHUNK, alpha=1.6))
    show("admm_chunk (streaming)", lambda: fused_admm.fused_admm_chunk_streaming(
        G, qp.A, gv, *vecs, K=K_CHUNK, alpha=1.6))
    for name, G_, kw in (
            ("admm_chunk_high", G, dict(dot_precision="high")),
            ("admm_chunk_default", G, dict(dot_precision="default")),
            ("admm_chunk_split", Ghi, dict(dot_precision="high", Glo=Glo)),
            ("admm_chunk_slab", S, dict(dot_precision="high", slab=True)),
            ("admm_chunk_lanes2", G, dict(dot_precision="high", lanes=2)),
            ("admm_chunk lanes 2, highest", G, dict(lanes=2)),
            ("admm_chunk_lanes4", G, dict(lanes=4))):
        show(name, lambda: fused_admm.fused_admm_chunk(
            G_, qp.A, gv, *vecs, K=K_CHUNK, alpha=1.6, **kw))
    del qp, S, G, gv, Ghi, Glo, vecs
    prob = device_prox_fleet(B_MAIN, N, ME, MI, generator=g)
    r = 0.0125 * (1.0 + torch.rand(B_MAIN, generator=g, device=DEVICE))
    S = fused_factor.fused_factor_solve(
        prob.P, (prob.A, prob.C), prob.q,
        r[:, None].expand(B_MAIN, ME + MI).contiguous(), sigma=0.0)
    G, gv = S[..., :ME + MI].contiguous(), S[..., ME + MI].contiguous()
    del S
    it = (torch.randn((B_MAIN, N), generator=g, device=DEVICE),
          torch.rand((B_MAIN, MI), generator=g, device=DEVICE),
          torch.randn((B_MAIN, ME), generator=g, device=DEVICE),
          torch.rand((B_MAIN, MI), generator=g, device=DEVICE))
    show("prox_chunk_cluster", lambda: fused_proxqp.fused_proxqp_chunk_cluster(
        G, prob.A, prob.C, gv, prob.b, prob.d, *it, r, act, K=K_PROX))
    show("prox_chunk (streaming)", lambda: fused_proxqp.fused_proxqp_chunk_streaming(
        G, prob.A, prob.C, gv, prob.b, prob.d, *it, r, act, K=K_PROX))
    for name, kw in (("prox_chunk_high", dict(dot_precision="high")),
                     ("prox_chunk_default", dict(dot_precision="default")),
                     ("prox_chunk_lanes2", dict(dot_precision="high", lanes=2)),
                     ("prox_chunk lanes 2, highest", dict(lanes=2))):
        show(name, lambda: fused_proxqp.fused_proxqp_chunk(
            G, prob.A, prob.C, gv, prob.b, prob.d, *it, r, act, K=K_PROX, **kw))


def counters():
    from quadraticprogramsolver_tpu_torch.ops import (
        fused_admm, fused_factor, fused_proxqp, routed_spmv, spd_kernels, spmv)

    return {"slab_build": fused_factor.build_slab,
            "pivot_sweep_v3": spd_kernels.spd_inverse_unrolled,
            "slab_level": fused_factor.slab_level,
            "admm_chunk": fused_admm.fused_admm_chunk,
            "prox_chunk": fused_proxqp.fused_proxqp_chunk,
            "admm_chunk_minv": fused_admm.fused_admm_chunk_minv,
            "prox_chunk_minv": fused_proxqp.fused_proxqp_chunk_minv,
            "pivot_sweep_2d": spd_kernels.spd_inverse_nb,
            "pivot_sweep_v3p": spd_kernels.spd_inverse_64p,
            "normal_inverse": spd_kernels.normal_inverse,
            "ell_matvec": spmv.ell_matvec,
            "routed_levels": routed_spmv.routed_levels_matvec,
            "row_routed_blocks": routed_spmv.row_routed_blocks,
            # The witness wrappers (WITNESS_WRAPPERS): no solver calls them.
            "routed_levels_prev": routed_spmv.routed_levels_prev,
            "row_routed_rows": routed_spmv.row_routed_rows,
            "slab_build_prev": fused_factor.build_slab_prev,
            "slab_level_prev": fused_factor.slab_level_prev,
            "pivot_sweep_v3_prev": spd_kernels.pivot_sweep_v3_prev,
            "ell_matvec_prev": spmv.ell_matvec_prev,
            "pivot_sweep_2d_prev": spd_kernels.pivot_sweep_2d_prev,
            "pivot_sweep_ref_prev": spd_kernels.pivot_sweep_ref_prev,
            "normal_inverse_prev": spd_kernels.normal_inverse_prev,
            "pivot_sweep_group_prev": spd_kernels.pivot_sweep_group_prev,
            "pivot_sweep_v3p_prev": spd_kernels.pivot_sweep_v3p_prev,
            "fused_admm_chunk_streaming": fused_admm.fused_admm_chunk_streaming,
            "fused_admm_chunk_cluster": fused_admm.fused_admm_chunk_cluster,
            "fused_proxqp_chunk_streaming":
                fused_proxqp.fused_proxqp_chunk_streaming,
            "fused_proxqp_chunk_cluster": fused_proxqp.fused_proxqp_chunk_cluster,
            "fused_admm_chunk_minv_streaming":
                fused_admm.fused_admm_chunk_minv_streaming,
            "fused_admm_chunk_minv_cluster": fused_admm.fused_admm_chunk_minv_cluster,
            "fused_proxqp_chunk_minv_streaming":
                fused_proxqp.fused_proxqp_chunk_minv_streaming,
            "fused_proxqp_chunk_minv_cluster":
                fused_proxqp.fused_proxqp_chunk_minv_cluster}


def _oracle_solve(args):
    import f64_oracle

    lane, kw = args
    return f64_oracle.solve_qp_reference(*lane, **kw)


def oracle_solves(lanes, pool=None, **kw):
    """f64_oracle.solve_qp_reference on each lane's (P, q, A, l, u): in
    ``pool``'s worker processes when one is given, else one after another."""
    jobs = [(lane, kw) for lane in lanes]
    if pool is None:
        return [_oracle_solve(j) for j in jobs]
    return list(pool.map(_oracle_solve, jobs))


def audit(qp, x, status, iters, label, required=True, prefix="phase 4",
          pool=None):
    """Max |x - x_ref|_inf over 8 spread + 8 most-iteration converged lanes;
    with ``required`` a breach of the target fails the run."""
    import numpy as np

    conv = np.where((status == 2) | (status == 3))[0]
    spread = conv[:: max(1, len(conv) // 8)][:8]
    worst = conv[np.argsort(iters[conv], kind="stable")[-8:]]
    idx = sorted(set(spread.tolist()) | set(worst.tolist()))
    devs = []
    lanes = [tuple(t[i].double().cpu().numpy() for t in qp.tensors())
             for i in idx]
    for i, ref in zip(idx, oracle_solves(lanes, pool, eps_abs=1e-6,
                                         eps_rel=1e-6, rho=0.1,
                                         max_iterations=20000)):
        require(ref.status == 3, f"{label}: oracle did not converge on lane {i}")
        devs.append(float(np.abs(x[i] - ref.x).max()))
    worst_dev = max(devs)
    log(f"[{prefix}] {label}: audit max|x - x_ref|_inf over {len(devs)} lanes "
        f"= {worst_dev:.3e} (target {AUDIT_TARGET:.0e})")
    require(not required or worst_dev <= AUDIT_TARGET,
            f"{label}: audit {worst_dev:.3e} > {AUDIT_TARGET:.0e}")
    return worst_dev


def run_main(torch, solve):
    """Warm solve, then best of 3; returns (solution, best seconds)."""
    sol = solve()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        sol = solve()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return sol, best


def factor_seconds(torch, qp, settings):
    """Best of 4: the factor of the solve's first pass, timed alone."""
    from quadraticprogramsolver_tpu_torch.models import kkt, proxqp

    rho = torch.full(qp.batch_shape, settings.rho, device=qp.device)

    def factor():
        if not isinstance(settings, proxqp.ProxQPSettings):
            kkt.cholesky_init(qp, rho, settings.sigma_for(qp.dtype), settings)
        elif settings.sigma_free_rhs:
            proxqp._build_sigma_free_cache(qp, rho, settings)
        else:
            proxqp._build_M_inv(qp, rho, settings.sigma)

    return best_seconds(torch, factor)


def times(dt, fdt, solved):
    """The timing part of a solve's line; empty for an untimed run."""
    if dt is None:
        return ""
    return (f"solve {dt * 1e3:.2f} ms (best of 3), {solved / dt:.1f} solves/s, "
            f"factor {fdt * 1e3:.2f} ms, iterate {(dt - fdt) * 1e3:.2f} ms, ")


def report_solve(qp, sol, dt, fdt, label):
    import numpy as np

    status = sol.info.status.cpu().numpy()
    iters = sol.info.iterations.cpu().numpy()
    x = sol.x.double().cpu().numpy()
    B = status.size
    solved = int(((status == 2) | (status == 3)).sum())
    log(f"[{label}] B={B}: {times(dt, fdt, solved)}solved {solved}/{B}, "
        f"iterations p50 {np.median(iters):.0f} max {iters.max()}, statuses "
        f"{ {int(k): int(v) for k, v in zip(*np.unique(status, return_counts=True))} }")
    require(bool(np.isfinite(x).all()) and x.shape == (B, qp.n),
            f"{label}: non-finite or misshapen x")
    require(solved == B, f"{label}: {B - solved} lanes did not end with "
            "status 2 or 3")
    return x, status, iters


def chunk_kernels(cnt, name, rule, label):
    """Chunk ``name``'s sigma-free launches of a run split by kernel (the
    cluster kernel's keys end in ",cluster"); the kernel the dispatch rule
    names for the run's variant (``rule``: "cluster" or "stream") must have
    launched."""
    variants = dict(cnt[name].variants)
    n_cluster = sum(v for k, v in variants.items() if k.endswith(",cluster"))
    split = {name: cnt[name].launches - n_cluster, f"{name}_cluster": n_cluster}
    want = f"{name}_cluster" if rule == "cluster" else name
    log(f"[{label}] {name} launches by kernel: {split} (variants {variants}); "
        f"the rule sends highest lanes 1 to {want}")
    require(split[want] > 0, f"{label}: {want} never launched")
    return split


def minv_cluster_only(cnt, name, label):
    """An M^{-1}-form chunk's launches of a lanes-1 run split by kernel
    (``chunk_kernels``): every one must have run the cluster kernel, which
    ops' ``minv_chunk_kernel`` names at 512/256 and 512/128/128."""
    split = chunk_kernels(cnt, name, "cluster", label)
    require(split[name] == 0, f"{label}: {split[name]} {name} launches "
            "streamed")
    return split


def factor_kernels(cnt, label):
    """The sigma-free factor's launches of a run: every build through the
    triangle kernel and LEVELS strip levels a build (``build_slab.variants``,
    ``slab_level.variants``: at "highest" the strip kernel is the only one
    ``slab_level`` launches), the witnesses at 0 (``read``)."""
    builds = cnt["slab_build"].launches
    by_build = dict(cnt["slab_build"].variants)
    by_level = dict(cnt["slab_level"].variants)
    log(f"[{label}] factor launches: builds {by_build}, levels {by_level}")
    require(builds > 0 and by_build == {"triangle": builds}
            and by_level == {"highest": LEVELS * builds},
            f"{label}: expected {LEVELS} strip levels for each of {builds} "
            f"triangle builds; got {by_build}, {by_level}")


def reset(cnt):
    for fn in cnt.values():
        fn.launches = 0
        if hasattr(fn, "variants"):
            fn.variants.clear()


def read(cnt, path, label, witnesses=False):
    """Launch counts of one path's run; every kernel of the path must move,
    and no witness wrapper (WITNESS_WRAPPERS) may: a solver never calls one.
    With ``witnesses`` their counts (0) join the returned ones."""
    launches = {k: cnt[k].launches for k in path}
    idle = {k: cnt[k].launches for k in WITNESS_WRAPPERS}
    log(f"[{label}] kernel launches: {launches}; witness wrappers "
        f"{sum(idle.values())}")
    require(all(v > 0 for v in launches.values()),
            f"{label}: a kernel of the path never launched: {launches}")
    require(not any(idle.values()),
            f"{label}: the solve launched a witness wrapper: {idle}")
    return {**launches, **idle} if witnesses else launches


def prox_audit(pkg, prob, sol, label, pool=None):
    """Max |x - x_ref|_inf over 4 spread + the 4 other converged lanes with
    the most iterations (ties broken by the larger final residual), each
    re-solved in f64 on its lowered box form."""
    import numpy as np

    status = sol.info.status.cpu().numpy()
    iters = sol.info.iterations.cpu().numpy()
    res = np.maximum(sol.info.res_prim.cpu().numpy(),
                     sol.info.res_dual.cpu().numpy())
    x = sol.x.double().cpu().numpy()
    spread = np.linspace(0, status.size - 1, 4).astype(int)
    conv = np.setdiff1d(np.where(status == 3)[0], spread)
    worst = conv[np.lexsort((res[conv], iters[conv]))[-4:]]
    idx = sorted(spread.tolist() + worst.tolist())
    devs = []
    lanes = [tuple(t[0].double().cpu().numpy() for t in pkg.ProxQPProblem(
        *(t[i:i + 1] for t in prob.tensors())).to_box_qp().tensors())
        for i in idx]
    for i, ref in zip(idx, oracle_solves(lanes, pool, eps_abs=1e-7,
                                         eps_rel=1e-7, rho=0.1,
                                         max_iterations=50000)):
        require(ref.status == 3, f"{label}: oracle did not converge on lane {i}")
        devs.append(float(np.abs(x[i] - ref.x).max()))
    worst_dev = max(devs)
    log(f"[{label}] audit max|x - x_ref|_inf over {len(devs)} lanes "
        f"{idx} = {worst_dev:.3e} (target {AUDIT_TARGET:.0e})")
    return worst_dev


def report_prox(prob, sol, dt, fdt, label):
    import numpy as np

    status = sol.info.status.cpu().numpy()
    iters = sol.info.iterations.cpu().numpy()
    x = sol.x.cpu().numpy()
    B = status.size
    solved = int((status == 3).sum())
    log(f"[{label}] B={B}: {times(dt, fdt, solved)}solved {solved}/{B}, "
        f"iterations p50 {np.median(iters):.0f} max {iters.max()}, statuses "
        f"{ {int(k): int(v) for k, v in zip(*np.unique(status, return_counts=True))} }")
    require(bool(np.isfinite(x).all()) and x.shape == (B, prob.n),
            f"{label}: non-finite or misshapen x")
    require(solved == B, f"{label}: {B - solved} lanes did not end with "
            "status 3")


#: Host time kept idle at each edge of a trace's active step.
TRACE_MARGIN_S = 0.05


def traced(torch, fn):
    """(profiler, wall ms) of one call of fn() traced by torch.profiler
    after a warm-up call in the same profiling run: a run that follows
    another one drops the first device events of its first step (the
    factor's first kernels went missing from later profiles), so the
    warm-up step takes that loss. The traced call also starts and ends
    TRACE_MARGIN_S from the active step's edges: a call launched right at
    an edge lost a kernel event there now and then (phase 10c's
    ``normal_inverse_prev``: its first or one of its last kernels)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()  # warm-up -> active; leaving the block ends the trace
        time.sleep(TRACE_MARGIN_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(TRACE_MARGIN_S)
    return prof, wall


def on_device(e):
    """A device event of a trace: a kernel or a copy, not the schedule's
    ProfilerStep annotation (which the trace files under the device)."""
    from torch.autograd import DeviceType

    return (e.device_type == DeviceType.CUDA
            and not e.key.startswith("ProfilerStep"))


def event_ms(e):
    """An averaged trace event's device time in ms."""
    v = getattr(e, "self_device_time_total", None)
    return (v if v is not None else e.self_cuda_time_total) / 1e3


#: The fused factor's device kernels as torch.profiler names them: the
#: redesigns (one triangle build, LEVELS strip levels a factor) and the
#: previous kernels, which a solve must not run.
FACTOR_TRACE = {"slab_build_kernel": 1, "level_strip_kernel": LEVELS}
PREV_TRACE = ("slab_gram_prev_kernel", "slab_rhs_prev_kernel",
              "level_dinvt_kernel", "level_update_kernel",
              "pivot_sweep_group_kernel")


def profile_solve(torch, solve, label, factor=False, want=None):
    """One profiled solve: device kernel time by name and the idle share;
    with ``factor`` (a one-factor solve), the trace must hold FACTOR_TRACE's
    kernels and ``want``'s (name -> launches) as often as they say and none
    of PREV_TRACE's."""
    solve()
    prof, wall = traced(torch, solve)
    # Device-side events only (kernels, copies): the host ops that launched
    # them carry the same time again.
    rows = sorted(((event_ms(e), e.count, e.key) for e in prof.key_averages()
                   if on_device(e) and event_ms(e) > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[{label}] profiled solve: wall {wall:.2f} ms, device kernels "
        f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}")
    for ms, count, key in rows[:15]:
        log(f"[{label}]   {ms:9.3f} ms  {count:5d} x  {key[:90]}")
    if factor:
        need = {**FACTOR_TRACE, **(want or {})}
        seen = {k: sum(c for _, c, key in rows if k in key)
                for k in (*need, *PREV_TRACE)}
        log(f"[{label}] factor kernels in the trace: {seen}")
        require(all(seen[k] == v for k, v in need.items())
                and not any(seen[k] for k in PREV_TRACE),
                f"{label}: the factor's kernels in the trace are {seen}")


def phase_prox(torch, pkg, cnt, profile):
    """Phase 6: the prox-ALM fleet at static and at adaptive rho."""
    from quadraticprogramsolver_tpu_torch.ops import fused_proxqp
    from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
        device_prox_fleet)

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    prob = device_prox_fleet(B_MAIN, N, ME, MI, generator=g)
    torch.cuda.synchronize()
    base = dict(max_iterations=2000, check_interval=25, kkt_warm_start=False,
                kkt_refinement_steps=0, sigma_free_rhs=True, fused_chunk=True,
                require_fused=True)
    levels = N // 128  # pivot launches per factor
    launches = None
    for adaptive, rho in ((False, 0.0125), (True, 0.1)):
        kind = "adaptive" if adaptive else "static"
        # The audit picks the lanes that exit nearest eps, and adaptive rho
        # exits right at it (ROADMAP "Audit margin"): tighten eps until the
        # audit passes.
        for eps in (5e-5, 2e-5, 1e-5):
            settings = pkg.ProxQPSettings(eps_abs=eps, eps_rel=eps, rho=rho,
                                          adaptive_rho=adaptive, **base)
            label = f"phase 6 {kind} rho, eps {eps:.0e}"
            torch.cuda.reset_peak_memory_stats()
            reset(cnt)
            sol = pkg.solve_proxqp(prob, settings)
            torch.cuda.synchronize()
            counts = read(cnt, PROX_PATH, label, witnesses=True)
            factor_kernels(cnt, label)
            counts.update(chunk_kernels(
                cnt, "prox_chunk", fused_proxqp.chunk_kernel(
                    N, ME, MI, 1, "highest"), label))
            log(f"[{label}] peak device memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            if adaptive:
                require(counts["pivot_sweep_v3"] > levels,
                        f"{label}: no refactor ({counts['pivot_sweep_v3']} "
                        f"pivot launches, {levels} per factor)")
                log(f"[{label}] refactors: "
                    f"{counts['pivot_sweep_v3'] // levels - 1}")
            else:
                launches = counts
            del sol
            sol, dt = run_main(torch, lambda: pkg.solve_proxqp(prob, settings))
            fdt = factor_seconds(torch, prob, settings)
            report_prox(prob, sol, dt, fdt, label)
            dev = prox_audit(pkg, prob, sol, label)
            del sol
            if dev <= AUDIT_TARGET:
                break
        require(dev <= AUDIT_TARGET, f"phase 6 {kind} rho: audit {dev:.3e} > "
                f"{AUDIT_TARGET:.0e} at eps 1e-5")
        if profile and not adaptive:
            profile_solve(torch, lambda: pkg.solve_proxqp(prob, settings),
                          "phase 6 profile", factor=True)
    return launches


class CallCount:
    """Counts the calls of ``owner.name`` between construction and close()."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.orig = getattr(owner, name)
        self.calls = 0

        def counted(*a, **k):
            self.calls += 1
            return self.orig(*a, **k)

        setattr(owner, name, counted)

    def close(self):
        setattr(self.owner, self.name, self.orig)


def best_seconds(torch, fn, reps=4):
    """Best of ``reps`` host-clock times of fn(), each ending in a sync."""
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def counted_solve(torch, cnt, solve, factor_owner, factor_name, path, label):
    """One solve with every launch counter at 0 before it: the path's
    kernels must launch, every factor build must run the sweep (LEVELS pivot
    launches) and no Cholesky may run. Returns (solution, launches, builds)."""
    builds = CallCount(factor_owner, factor_name)
    chol = CallCount(torch.linalg, "cholesky")
    try:
        torch.cuda.reset_peak_memory_stats()
        reset(cnt)
        sol = solve()
        torch.cuda.synchronize()
    finally:
        builds.close()
        chol.close()
    counts = read(cnt, path, label)
    log(f"[{label}] factor builds {builds.calls} (refactors "
        f"{builds.calls - 1}), torch.linalg.cholesky calls {chol.calls}, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    require(chol.calls == 0, f"{label}: Cholesky ran on the sweep's shapes")
    require(counts["pivot_sweep_v3"] == LEVELS * builds.calls,
            f"{label}: {counts['pivot_sweep_v3']} pivot launches for "
            f"{builds.calls} factor builds ({LEVELS} per build)")
    return sol, counts, builds.calls


def cholesky_yardstick(torch, M, label, fdt):
    """The factor's yardstick: one library Cholesky inverse of the same M."""
    cdt = best_seconds(torch, lambda: torch.cholesky_inverse(torch.linalg.cholesky(M)))
    log(f"[{label}] factor {fdt * 1e3:.2f} ms (sweep, timed alone) vs "
        f"{cdt * 1e3:.2f} ms torch.cholesky_inverse(torch.linalg.cholesky(M)) "
        f"on the same M (best of 4)")
    return cdt


def phase_minv(torch, pkg, cnt, profile):
    """Phase 7: the M^{-1} form of both families at B=2048."""
    from quadraticprogramsolver_tpu_torch.models import kkt, proxqp
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)
    from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
        device_prox_fleet)

    launches = {}
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    qp = device_random_qp_fleet(B_DEFAULTS, N, M, generator=g)
    torch.cuda.synchronize()
    for fused, tag in ((False, "7a"), (True, "7b")):
        knobs = dict(fused_chunk=True, require_fused=True) if fused else {}
        chunk = "fused_kernel" if fused else "torch"
        path = ADMM_MINV_PATH if fused else ADMM_DEFAULTS_PATH
        for eps in (1e-4, 2e-5, 1e-5):
            settings = pkg.Settings(max_iterations=2000, eps_abs=eps,
                                    eps_rel=eps, **knobs)
            label = f"phase {tag} eps {eps:.0e}"
            p = pkg.plan(qp, settings)
            log(f"[{label}] plan: factor {p.factor}, chunk {p.chunk}, cache "
                f"{p.cache}")
            require((p.factor, p.chunk, p.cache) == ("sweep_inverse", chunk, "M_inv"),
                     f"{label}: unexpected plan {p}")
            sol, counts, builds = counted_solve(
                torch, cnt, lambda: pkg.solve(qp, settings), kkt,
                "cholesky_init", path, label)
            iters = sol.info.iterations.cpu().numpy()
            if fused:
                chunks = int(iters.max()) // settings.check_interval
                require(counts["admm_chunk_minv"] == chunks,
                        f"{label}: {counts['admm_chunk_minv']} M^-1 chunk "
                        f"launches for {chunks} checks")
                counts.update(minv_cluster_only(cnt, "admm_chunk_minv", label))
            x, status, iters = report_solve(qp, sol, None, None, f"{label} counted")
            del sol
            dev = audit(qp, x, status, iters, label, required=False,
                        prefix=f"phase {tag}")
            if dev <= AUDIT_TARGET:
                break
        require(dev <= AUDIT_TARGET, f"phase {tag}: audit {dev:.3e} > "
                f"{AUDIT_TARGET:.0e} at eps 1e-5")
        launches["admm_minv" if fused else "admm_defaults"] = counts
        sol, dt = run_main(torch, lambda: pkg.solve(qp, settings))
        fdt = factor_seconds(torch, qp, settings)
        report_solve(qp, sol, dt, fdt, f"{label} refactors {builds - 1}")
        del sol
        rho_row = torch.full((B_DEFAULTS, M), settings.rho, device=DEVICE)
        Mn = kkt._build_normal_matrix(qp, rho_row, settings.sigma_for(qp.dtype))
        cholesky_yardstick(torch, Mn, label, fdt)
        del Mn
        if profile:
            profile_solve(torch, lambda: pkg.solve(qp, settings),
                          f"phase {tag} profile")
    del qp

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    prob = device_prox_fleet(B_DEFAULTS, N, ME, MI, generator=g)
    torch.cuda.synchronize()
    for eps in (1e-4, 2e-5, 1e-5):
        settings = pkg.ProxQPSettings(
            max_iterations=2000, eps_abs=eps, eps_rel=eps, rho=0.1,
            adaptive_rho=True, kkt_refinement_steps=REFINE, check_interval=50,
            kkt_warm_start=False, fused_chunk=True, require_fused=True)
        label = f"phase 7c eps {eps:.0e}"
        p = pkg.plan_proxqp(prob, settings)
        log(f"[{label}] plan: factor {p.factor}, chunk {p.chunk}, cache {p.cache}")
        require((p.factor, p.chunk, p.cache)
                == ("sweep_inverse", "fused_kernel", "M_inv"),
                f"{label}: unexpected plan {p}")
        sol, counts, builds = counted_solve(
            torch, cnt, lambda: pkg.solve_proxqp(prob, settings), proxqp,
            "_build_M_inv", PROX_MINV_PATH, label)
        iters = sol.info.iterations.cpu().numpy()
        chunks = int(iters.max()) // settings.check_interval
        require(counts["prox_chunk_minv"] == chunks,
                f"{label}: {counts['prox_chunk_minv']} M^-1 prox chunk "
                f"launches for {chunks} checks")
        counts.update(minv_cluster_only(cnt, "prox_chunk_minv", label))
        report_prox(prob, sol, None, None, f"{label} counted")
        dev = prox_audit(pkg, prob, sol, label)
        rho_end = sol.info.rho[:B_KERNEL].to(torch.float32).contiguous()
        del sol
        if dev <= AUDIT_TARGET:
            break
    require(dev <= AUDIT_TARGET, f"phase 7c: audit {dev:.3e} > "
            f"{AUDIT_TARGET:.0e} at eps 1e-5")
    launches["prox_minv"] = counts
    # The M^{-1} prox kernel against its f64 witness at the penalties the
    # counted run ended with, after its refactors, on its first lanes.
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    lanes = pkg.ProxQPProblem(*(t[:B_KERNEL] for t in prob.tensors()))
    iterates = (torch.randn((B_KERNEL, N), generator=g, device=DEVICE),
                torch.rand((B_KERNEL, MI), generator=g, device=DEVICE),
                torch.randn((B_KERNEL, ME), generator=g, device=DEVICE),
                torch.rand((B_KERNEL, MI), generator=g, device=DEVICE))
    active = torch.arange(B_KERNEL, device=DEVICE) % 4 != 3
    failures = []
    log(f"[phase 7c witness] end rho over lanes 0-{B_KERNEL - 1}: "
        f"{float(rho_end.min()):.4g}-{float(rho_end.max()):.4g}")
    prox_minv_witness(torch, lanes, rho_end, iterates, active,
                      "phase 7c witness, end rho", failures)
    require(not failures, "; ".join(failures))
    del lanes, iterates
    sol, dt = run_main(torch, lambda: pkg.solve_proxqp(prob, settings))
    fdt = factor_seconds(torch, prob, settings)
    report_prox(prob, sol, dt, fdt, f"{label} refactors {builds - 1}")
    del sol
    if profile:
        profile_solve(torch, lambda: pkg.solve_proxqp(prob, settings),
                      "phase 7c profile")
    rho = torch.full((B_DEFAULTS,), settings.rho, device=DEVICE)
    Mn = prob.P + settings.sigma * torch.eye(N, device=DEVICE) + rho[:, None, None] * (
        prob.A.transpose(1, 2) @ prob.A + prob.C.transpose(1, 2) @ prob.C)
    cholesky_yardstick(torch, Mn, label, fdt)
    return launches


def read_variants(cnt, name, want, label):
    """Launches of each variant of chunk ``name`` in one counted run; every
    variant in ``want`` must have launched, every launch is a variant, and
    every one ran a cluster kernel (its key ends in ",cluster"): the stacks'
    lanes fit one."""
    variants = dict(cnt[name].variants)
    log(f"[{label}] {name} launches by variant: {variants}")
    require(all(variants.get(k, 0) > 0 for k in want),
            f"{label}: a variant of the stack never launched: {variants}, "
            f"expected {want}")
    require(sum(variants.values()) == cnt[name].launches,
            f"{label}: {name} launches outside its variants")
    require(all(k.endswith(",cluster") for k in variants),
            f"{label}: a {name} launch streamed: {variants}")
    return variants


@contextlib.contextmanager
def streaming_witness(cnt, name, label):
    """Inside the block every chunk of both families runs its streaming
    kernel, the cluster kernels' witness: each module's dispatch rules
    (``chunk_kernel``, ``minv_chunk_kernel``) answer "stream" (this script
    alone does this; no solver can). The block's launches of chunk ``name``
    are counted apart, reset before and read after it, and every one must
    have streamed (no ",cluster" key)."""
    from quadraticprogramsolver_tpu_torch.ops import fused_admm, fused_proxqp

    saved = [(mod, rule, getattr(mod, rule)) for mod in (fused_admm, fused_proxqp)
             for rule in ("chunk_kernel", "minv_chunk_kernel")]
    reset(cnt)
    for mod, rule, _ in saved:
        setattr(mod, rule, lambda *a, **k: "stream")
    try:
        yield
    finally:
        for mod, rule, fn in saved:
            setattr(mod, rule, fn)
    variants = dict(cnt[name].variants)
    log(f"[{label}] witness solve: {name} launches by variant {variants}")
    require(variants and not any(k.endswith(",cluster") for k in variants),
            f"{label}: the witness solve did not stream: {variants}")
    reset(cnt)


def same_solve(a, b, label):
    """The cluster solve ``a`` against its streaming witness ``b``: the same
    statuses and iterations, x bit for bit."""
    dx = float((a.x - b.x).abs().max())
    same = (bool((a.info.status == b.info.status).all())
            and bool((a.info.iterations == b.info.iterations).all()) and dx == 0.0)
    log(f"[{label}] cluster chunks against their streaming witness: statuses "
        f"and iterations equal, max |dx| {dx:.3e}: {same}")
    require(same, f"{label}: the cluster chunks changed the solve")


#: Phase 8: bench.py's tuned stacks (bench.py:200-206 headline_settings on
#: phase 3's knobs at static rho; the baseline_shape row, bench.py:495):
#: tag -> (fleet n, m; knobs; the chunk variants each must launch).
SLAB_SETTINGS = dict(slab_cache=True, chunk_lanes=2, chunk_dot_precision="high",
                     first_chunk_dot_precision="default")
STACKS = {
    "8a slab_settings": ((N, M), SLAB_SETTINGS,
                         ("default,slab,lanes2,cluster", "high,slab,lanes2,cluster")),
    "8b slab_hi": ((N, M), dict(slab_cache=True, chunk_lanes=4,
                                first_chunk_dot_precision="default"),
                   ("default,slab,lanes4,cluster", "highest,slab,lanes4,cluster")),
    "8c split_cache": ((N, M), dict(split_cache=True, chunk_lanes=2,
                                    chunk_dot_precision="high"),
                       ("high,split,lanes2,cluster",)),
    "8d baseline_shape 500/250": ((500, 250), SLAB_SETTINGS,
                                  ("default,slab,lanes2,cluster",
                                   "high,slab,lanes2,cluster")),
}
#: The prox headline stack (benchmarks/proxqp_fleet.py --headline).
PROX_HEADLINE = dict(max_iterations=2000, rho=0.0125, adaptive_rho=False,
                     check_interval=25, kkt_warm_start=False,
                     kkt_refinement_steps=0, sigma_free_rhs=True,
                     fused_chunk=True, chunk_lanes=2, chunk_dot_precision="high",
                     first_chunk_dot_precision="default", require_fused=True)


def phase_stacks(torch, pkg, cnt, profile):
    """Phase 8: the tuned stacks, each tightening eps while its audit fails;
    returns each stack's kernel and variant launch counts."""
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)
    from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
        device_prox_fleet)

    runs, qp, shape = {}, None, None
    for tag, ((n, m), knobs, want) in STACKS.items():
        if (n, m) != shape:
            qp = None
            g = torch.Generator(device=DEVICE).manual_seed(SEED)
            qp, shape = device_random_qp_fleet(B_MAIN, n, m, generator=g), (n, m)
            torch.cuda.synchronize()
        for eps in (1e-4, 2e-5, 1e-5):
            settings = pkg.Settings(
                max_iterations=2000, eps_abs=eps, eps_rel=eps, rho=0.4,
                check_interval=11, kkt_refinement_steps=0, sigma_free_rhs=True,
                fused_factor=True, fused_chunk=True, require_fused=True,
                adaptive_rho=False, **knobs)
            label = f"phase {tag}, eps {eps:.0e}"
            p = pkg.plan(qp, settings)
            log(f"[{label}] plan: cache {p.cache}, lanes {p.lanes}, "
                f"dot_precision {p.dot_precision}, padded {p.padded}")
            torch.cuda.reset_peak_memory_stats()
            reset(cnt)
            sol = pkg.solve(qp, settings)
            torch.cuda.synchronize()
            counts = read(cnt, ADMM_PATH, label)
            variants = read_variants(cnt, "admm_chunk", want, label)
            peak = torch.cuda.max_memory_allocated() / 1e9
            x, status, iters = report_solve(qp, sol, None, None, f"{label} counted")
            del sol
            dev = audit(qp, x, status, iters, label, required=False,
                        prefix=f"phase {tag[:2]}")
            if dev <= AUDIT_TARGET:
                break
        require(dev <= AUDIT_TARGET, f"phase {tag}: audit {dev:.3e} > "
                f"{AUDIT_TARGET:.0e} at eps 1e-5")
        sol, dt = run_main(torch, lambda: pkg.solve(qp, settings))
        fqp = qp if p.padded is None else pkg.pad_qp(qp, *p.padded)
        fdt = factor_seconds(torch, fqp, settings)
        del fqp
        report_solve(qp, sol, dt, fdt, f"phase {tag}, eps {eps:.0e}")
        log(f"[phase {tag}] eps {eps:.0e}, audit {dev:.3e}, peak device "
            f"memory {peak:.2f} GB")
        with streaming_witness(cnt, "admm_chunk", f"phase {tag}"):
            wsol, wdt = run_main(torch, lambda: pkg.solve(qp, settings))
        log(f"[phase {tag}] streaming witness solve {wdt * 1e3:.2f} ms "
            f"(best of 3) against the cluster solve's {dt * 1e3:.2f} ms")
        same_solve(sol, wsol, f"phase {tag}")
        del sol, wsol
        runs[tag[:2]] = {"kernels": counts, "variants": variants}
        if profile and tag.startswith("8a"):
            profile_solve(torch, lambda: pkg.solve(qp, settings), "phase 8a profile")
    del qp

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    prob = device_prox_fleet(B_MAIN, N, ME, MI, generator=g)
    torch.cuda.synchronize()
    for eps in (5e-5, 2e-5, 1e-5):
        settings = pkg.ProxQPSettings(eps_abs=eps, eps_rel=eps, **PROX_HEADLINE)
        label = f"phase 8e prox headline, eps {eps:.0e}"
        torch.cuda.reset_peak_memory_stats()
        reset(cnt)
        sol = pkg.solve_proxqp(prob, settings)
        torch.cuda.synchronize()
        counts = read(cnt, PROX_PATH, label)
        variants = read_variants(cnt, "prox_chunk",
                                 ("default,lanes2,cluster", "high,lanes2,cluster"),
                                 label)
        peak = torch.cuda.max_memory_allocated() / 1e9
        report_prox(prob, sol, None, None, f"{label} counted")
        dev = prox_audit(pkg, prob, sol, label)
        del sol
        if dev <= AUDIT_TARGET:
            break
    require(dev <= AUDIT_TARGET, f"phase 8e: audit {dev:.3e} > "
            f"{AUDIT_TARGET:.0e} at eps 1e-5")
    sol, dt = run_main(torch, lambda: pkg.solve_proxqp(prob, settings))
    fdt = factor_seconds(torch, prob, settings)
    report_prox(prob, sol, dt, fdt, f"phase 8e prox headline, eps {eps:.0e}")
    log(f"[phase 8e] eps {eps:.0e}, audit {dev:.3e}, peak device memory "
        f"{peak:.2f} GB")
    with streaming_witness(cnt, "prox_chunk", "phase 8e"):
        wsol, wdt = run_main(torch, lambda: pkg.solve_proxqp(prob, settings))
    log(f"[phase 8e] streaming witness solve {wdt * 1e3:.2f} ms (best of 3) "
        f"against the cluster solve's {dt * 1e3:.2f} ms")
    same_solve(sol, wsol, "phase 8e")
    del sol, wsol
    runs["8e"] = {"kernels": counts, "variants": variants}
    if profile:
        profile_solve(torch, lambda: pkg.solve_proxqp(prob, settings),
                      "phase 8e profile")
    del prob
    runs.update(phase_minv_lanes(torch, pkg, cnt, profile))
    return runs


def phase_minv_lanes(torch, pkg, cnt, profile):
    """8f, 8g: phase 7b's and 7c's stacks (at the eps their audits passed)
    with chunk_lanes=2 against chunk_lanes=1, each timed in this call, and
    the lanes-2 solve again with every chunk on its streaming witness
    (``streaming_witness``): the same statuses and iterations, the same x
    bit for bit. Both lane counts run the M^{-1} cluster kernels (every
    launch under its ",cluster" key), so this holds them to their witnesses
    through whole solves. ``profile`` traces 8f's lanes-2 solve."""
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)
    from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
        device_prox_fleet)

    runs = {}
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    qp = device_random_qp_fleet(B_DEFAULTS, N, M, generator=g)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    prob = device_prox_fleet(B_DEFAULTS, N, ME, MI, generator=g)
    cases = (
        ("8f", "admm_chunk_minv", ADMM_MINV_PATH, pkg.solve, qp,
         lambda lanes: pkg.Settings(max_iterations=2000, eps_abs=1e-4,
                                    eps_rel=1e-4, fused_chunk=True,
                                    require_fused=True, chunk_lanes=lanes)),
        ("8g", "prox_chunk_minv", PROX_MINV_PATH, pkg.solve_proxqp, prob,
         lambda lanes: pkg.ProxQPSettings(
             max_iterations=2000, eps_abs=2e-5, eps_rel=2e-5, rho=0.1,
             adaptive_rho=True, kkt_refinement_steps=REFINE, check_interval=50,
             kkt_warm_start=False, fused_chunk=True, require_fused=True,
             chunk_lanes=lanes)))
    for tag, name, path, solve, fleet, make in cases:
        sols = {}
        for lanes in (1, 2):
            settings = make(lanes)
            label = f"phase {tag} {name} lanes {lanes}"
            reset(cnt)
            sols[lanes] = solve(fleet, settings)
            torch.cuda.synchronize()
            counts = read(cnt, path, label)
            want = f"lanes{lanes},cluster"
            variants = read_variants(cnt, name, (want,), label)
            require(set(variants) == {want},
                    f"{label}: expected only {want} launches; got {variants}")
            _, dt = run_main(torch, lambda: solve(fleet, settings))
            info = sols[lanes].info
            log(f"[{label}] solve {dt * 1e3:.2f} ms (best of 3), "
                f"{info.status.numel() / dt:.1f} solves/s, iterations p50 "
                f"{float(info.iterations.float().median()):.0f} max "
                f"{int(info.iterations.max())}")
        with streaming_witness(cnt, name, f"phase {tag}"):
            wsol = solve(fleet, settings)
            _, wdt = run_main(torch, lambda: solve(fleet, settings))
        log(f"[phase {tag} {name} lanes 2] streaming witness solve "
            f"{wdt * 1e3:.2f} ms (best of 3)")
        a, b = sols[1], sols[2]
        dx = float((a.x - b.x).abs().max())
        log(f"[phase {tag}] lanes 2 vs lanes 1: max |dx| {dx:.3e}")
        require(torch.equal(a.info.status, b.info.status)
                and torch.equal(a.info.iterations, b.info.iterations)
                and dx == 0.0, f"phase {tag}: lanes 2 changed the solve")
        same_solve(b, wsol, f"phase {tag}")
        if profile and tag == "8f":
            profile_solve(torch, lambda: solve(fleet, settings),
                          "phase 8f profile")
        runs[tag] = {"kernels": counts, "variants": variants}
        del sols, a, b, wsol
    return runs


#: Phase 9: the fused factor's knobs, one at a time on phase 3's stack:
#: tag -> (knobs, the pivot formulation and level precision every factor
#: build must launch, LEVELS times each).
FACTOR_KNOBS = {
    **{f"9{t} {v}": (dict(pivot_variant=v), v, "highest")
       for t, v in zip("abcdef", ("ref", "value", "r2", "r4", "r8", "panel"))},
    "9g high": (dict(factor_precision="high"), "v3", "high"),
}


def phase_factor_knobs(torch, pkg, cnt, base, profile):
    """Phase 9: phase 3's fleet and static-rho knobs with one factor knob
    changed, each tightening eps while its audit fails; returns each
    stack's launches and solve ms."""
    from quadraticprogramsolver_tpu_torch.models import kkt
    from quadraticprogramsolver_tpu_torch.ops import fused_factor, spd_kernels
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    qp = device_random_qp_fleet(B_MAIN, N, M, generator=g)
    torch.cuda.synchronize()
    runs = {}
    for tag, (knobs, pivot, level) in FACTOR_KNOBS.items():
        for eps in (1e-4, 2e-5, 1e-5):
            settings = pkg.Settings(**dict(base, eps_abs=eps, eps_rel=eps),
                                    adaptive_rho=False, **knobs)
            label = f"phase {tag}, eps {eps:.0e}"
            builds = CallCount(kkt, "cholesky_init")
            try:
                torch.cuda.reset_peak_memory_stats()
                reset(cnt)
                sol = pkg.solve(qp, settings)
                torch.cuda.synchronize()
            finally:
                builds.close()
            counts = read(cnt, ADMM_PATH, label)
            idle = {k: cnt[k].launches for k in WITNESS_WRAPPERS}
            piv = dict(spd_kernels.spd_inverse_unrolled.variants)
            lev = dict(fused_factor.slab_level.variants)
            peak = torch.cuda.max_memory_allocated() / 1e9
            log(f"[{label}] factor builds {builds.calls}, pivot launches by "
                f"formulation {piv}, level launches by precision {lev}")
            want = LEVELS * builds.calls
            require(piv == {pivot: want} and lev == {level: want},
                    f"{label}: expected {want} launches of pivot {pivot!r} "
                    f"and level {level!r} alone; got {piv}, {lev}")
            x, status, iters = report_solve(qp, sol, None, None, f"{label} counted")
            del sol
            dev = audit(qp, x, status, iters, label, required=False,
                        prefix=f"phase {tag[:2]}")
            if dev <= AUDIT_TARGET:
                break
        require(dev <= AUDIT_TARGET, f"phase {tag}: audit {dev:.3e} > "
                f"{AUDIT_TARGET:.0e} at eps 1e-5")
        sol, dt = run_main(torch, lambda: pkg.solve(qp, settings))
        fdt = factor_seconds(torch, qp, settings)
        report_solve(qp, sol, dt, fdt, f"phase {tag}, eps {eps:.0e}")
        log(f"[phase {tag}] eps {eps:.0e}, audit {dev:.3e}, peak device "
            f"memory {peak:.2f} GB")
        del sol
        runs[tag[:2]] = {"kernels": counts, "pivot": piv, "level": lev,
                         "witnesses": idle, "settings": settings,
                         "ms": dt * 1e3}
    if profile:
        # 9g and the fastest group formulation: the factor's trace must name
        # the knob's kernel LEVELS times and no previous kernel.
        fast = min(("9c", "9d", "9e", "9f"), key=lambda k: runs[k]["ms"])
        for tag, want in ((fast, {"group_sweep_kernel": LEVELS}),
                          ("9g", {"level_strip_kernel_high": LEVELS})):
            st = runs[tag]["settings"]
            profile_solve(torch, lambda: pkg.solve(qp, st), f"phase {tag} profile",
                          factor=True, want=want)
    return runs


def best_ms(torch, fn, reps=3):
    """A warm call, then the best of ``reps`` host-clock ms, each call
    ending in a sync."""
    fn()
    torch.cuda.synchronize()
    return best_seconds(torch, fn, reps) * 1e3


def rel_f64(out, ref, idx):
    """max |out - ref| over lanes ``idx`` relative to max |ref| (ref: f64
    inverses of those lanes)."""
    return float((out[idx].double() - ref).abs().max() / ref.abs().max())


#: The device kernels of csrc/normal_inverse.cu's fixed sequence by launch
#: kind, and those of its witness (the first port's sequence).
NORMAL_INVERSE_KERNELS = {"gram": "normal_gram_kernel",
                          "pivot": "sweep_block_kernel",
                          "CD": "normal_cd_kernel",
                          "strip": "normal_strip_kernel"}
NORMAL_INVERSE_PREV_KERNELS = {"gram": "normal_gram_prev_kernel",
                               "pivot": "sweep_block_prev_kernel",
                               "products": "normal_level_products_prev_kernel",
                               "update": "normal_level_update_prev_kernel"}


def device_kernels(torch, fn):
    """The device kernels that one call of fn ran, as torch.profiler traced
    them: name -> (launches, device ms)."""
    prof, _ = traced(torch, fn)
    return {e.key: (e.count, event_ms(e)) for e in prof.key_averages()
            if on_device(e)}


def by_kind(traced_kernels, kinds):
    """A traced call's launches and device ms summed by launch kind
    (``kinds``: kind -> a kernel name its trace names contain)."""
    return {kind: (sum(c for k, (c, _) in traced_kernels.items() if name in k),
                   sum(ms for k, (_, ms) in traced_kernels.items() if name in k))
            for kind, name in kinds.items()}


def counted_call(torch, cnt, fn, name, label):
    """One call with every launch counter at 0 before it; returns (its
    result, the launches of ``name``, which must be > 0)."""
    reset(cnt)
    res = fn()
    torch.cuda.synchronize()
    return res, read(cnt, (name,), label)[name]


def phase_entry_points(torch, pkg, cnt, extra):
    """Phase 10: the SPD-inverse entry points at sizes users run. 10a the
    pivot_inverse_probe shootout, 10b the flat sweep, 10c the fused
    normal-matrix inverse, 10d phase 7a's solve with TF32 on. Returns each
    new kernel's launches in its counted call."""
    from quadraticprogramsolver_tpu_torch.models import kkt
    from quadraticprogramsolver_tpu_torch.ops import linalg, spd_kernels as sk
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)

    launches, failures = {}, []
    # 10a: benchmarks/pivot_inverse_probe.py's shootout on its defaults.
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    Dm = torch.randn((B_PROBE, 128, 128), generator=g, device=DEVICE)
    D = Dm.transpose(1, 2) @ Dm / 128 + 0.05 * torch.eye(128, device=DEVICE)
    del Dm
    idx = [0, B_PROBE // 2, B_PROBE - 1]
    ref = torch.linalg.inv(D[idx].double())
    inv = sk.spd_inverse_unrolled
    cands = {**{v: (lambda v=v: inv(D, variant=v))
                for v in ("v3", "ref", "r2", "r4", "r8", "panel")},
             "spd_inverse_nb (row 6)": lambda: sk.spd_inverse_nb(D),
             "spd_inverse_128_schur (row 11)": lambda: sk.spd_inverse_128_schur(D),
             "torch.linalg.inv": lambda: torch.linalg.inv(D),
             "cholesky inverse": lambda: torch.cholesky_inverse(torch.linalg.cholesky(D))}
    shootout = {}
    for name, fn in cands.items():
        ms = best_ms(torch, fn)
        err = rel_f64(fn(), ref, idx)
        shootout[name] = {"ms": ms, "rel_err_f64": err}
        log(f"[phase 10a] B={B_PROBE} {name:32s}: {ms:8.3f} ms (best of 3), "
            f"rel err {err:.2e} (lanes {idx})")
    for name in ("spd_inverse_nb (row 6)", "spd_inverse_128_schur (row 11)"):
        if not shootout[name]["rel_err_f64"] <= PROBE_MARK:
            failures.append(f"phase 10a {name}: rel err "
                            f"{shootout[name]['rel_err_f64']:.2e} > {PROBE_MARK:.0e}")
    _, launches["pivot_sweep_v3p"] = counted_call(
        torch, cnt, lambda: sk.spd_inverse_128_schur(D), "pivot_sweep_v3p",
        "phase 10a spd_inverse_128_schur")
    launches["pivot_sweep_v3p_prev"] = cnt["pivot_sweep_v3p_prev"].launches
    require(launches["pivot_sweep_v3p"] == 2, "phase 10a: the Schur inverse "
            f"launched {launches['pivot_sweep_v3p']} paired sweeps, not 2")
    extra["pivot_sweep_v3p"]["shootout"] = shootout
    del D, ref

    # 10b: the flat sweep on phase 7a's normal matrices (bench.py's defaults).
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    qp = device_random_qp_fleet(B_DEFAULTS, N, M, generator=g)
    st = pkg.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4)
    rho_row = torch.full((B_DEFAULTS, M), st.rho, device=DEVICE)
    Mn = kkt._build_normal_matrix(qp, rho_row, st.sigma_for(qp.dtype))
    idx = [0, B_DEFAULTS // 2, B_DEFAULTS - 1]
    ref = torch.linalg.inv(Mn[idx].double())
    sweeps = {}
    prev_sweep = lambda: sk.spd_inverse_sweep(  # noqa: E731
        Mn, pivot_inverse=sk.pivot_sweep_2d_prev)
    same = torch.equal(sk.spd_inverse_sweep(Mn), prev_sweep())
    log(f"[phase 10b] spd_inverse_sweep bit for bit the same sweep on "
        f"pivot_sweep_2d_prev: {same}")
    if not same:
        failures.append("phase 10b: the sweep's row-6 kernel is not its "
                        "witness's bits")
    for name, fn in (("spd_inverse_sweep", lambda: sk.spd_inverse_sweep(Mn)),
                     ("spd_inverse_sweep on pivot_sweep_2d_prev", prev_sweep),
                     ("spd_inverse_sweep_fused",
                      lambda: sk.spd_inverse_sweep_fused(Mn))):
        ms = best_ms(torch, fn)
        err = rel_f64(fn(), ref, idx)
        sweeps[name] = {"ms": ms, "rel_err_f64": err}
        log(f"[phase 10b] B={B_DEFAULTS}, n={N}: {name}: {ms:.2f} ms (best "
            f"of 3), rel err {err:.2e} (lanes {idx})")
    _, launches["pivot_sweep_2d"] = counted_call(
        torch, cnt, lambda: sk.spd_inverse_sweep(Mn), "pivot_sweep_2d",
        "phase 10b spd_inverse_sweep")
    launches["pivot_sweep_2d_prev"] = cnt["pivot_sweep_2d_prev"].launches
    require(launches["pivot_sweep_2d"] == LEVELS, "phase 10b: "
            f"{launches['pivot_sweep_2d']} row-6 launches, not {LEVELS}")
    extra.setdefault("pivot_sweep_2d", {})["sweep"] = sweeps
    del ref

    # 10c: the fused normal-matrix inverse on the same fleet, one rho a lane.
    rho_v, sigma = 0.1, 1e-6
    rho = torch.full((B_DEFAULTS,), rho_v, device=DEVICE)
    row = torch.full((B_DEFAULTS, M), rho_v, device=DEVICE)  # uniform rows
    del Mn
    peaks = {}
    for name, fn in (
            ("normal_inverse", lambda: sk.normal_inverse(qp.P, qp.A, rho, sigma=sigma)),
            ("normal_inverse_prev", lambda: sk.normal_inverse_prev(
                qp.P, qp.A, rho, sigma=sigma)),
            ("M^-1 route (build + sweep)", lambda: linalg.spd_inverse(
                kkt._build_normal_matrix(qp, row, sigma)))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = best_ms(torch, fn)
        peaks[name] = {"ms": ms,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"[phase 10c] B={B_DEFAULTS}, n={N}, m={M}: {name}: {ms:.2f} ms "
            f"(best of 3), peak device memory {peaks[name]['peak_gb']:.2f} GB "
            "(the fleet included)")
    out, launches["normal_inverse"] = counted_call(
        torch, cnt, lambda: sk.normal_inverse(qp.P, qp.A, rho, sigma=sigma),
        "normal_inverse", "phase 10c normal_inverse")
    launches["normal_inverse_prev"] = cnt["normal_inverse_prev"].launches
    require(launches["normal_inverse"] == 1, "phase 10c: "
            f"{launches['normal_inverse']} counted launches for one call")
    same = torch.equal(out, sk.normal_inverse_prev(qp.P, qp.A, rho, sigma=sigma))
    log(f"[phase 10c] normal_inverse bit for bit normal_inverse_prev: {same}")
    if not same:
        failures.append("phase 10c: normal_inverse is not the previous "
                        "kernels' bits")
    split = {}
    for name, kinds in (("normal_inverse", NORMAL_INVERSE_KERNELS),
                        ("normal_inverse_prev", NORMAL_INVERSE_PREV_KERNELS)):
        fn = getattr(sk, name)
        traced = device_kernels(torch, lambda: fn(qp.P, qp.A, rho, sigma=sigma))
        split[name] = by_kind(traced, kinds)
        device_launches = sum(c for c, _ in split[name].values())
        total = sum(c for c, _ in traced.values())
        log(f"[phase 10c] {name}: one call ran {device_launches} device "
            f"kernels of its sequence (traced, all kernels: {total}); device "
            "ms by launch kind: " + ", ".join(
                f"{kind} {ms:.3f} ({c})" for kind, (c, ms) in split[name].items()))
        require(device_launches == 1 + 3 * (N // 128) == total,
                f"phase 10c: one {name} call traced {traced}, not the "
                f"1 + 3 n/128 = {1 + 3 * (N // 128)} kernels of its sequence")
    device_launches = sum(c for c, _ in split["normal_inverse"].values())
    Mf = (qp.P[idx].double() + sigma * torch.eye(N, device=DEVICE, dtype=torch.float64)
          + rho_v * qp.A[idx].double().transpose(1, 2) @ qp.A[idx].double())
    ref = torch.linalg.inv(Mf)
    err = rel_f64(out, ref, idx)
    resid = float((out[idx].double() @ Mf - torch.eye(
        N, device=DEVICE, dtype=torch.float64)).abs().max())
    log(f"[phase 10c] normal_inverse against f64 (lanes {idx}): rel err "
        f"{err:.2e}, residual |M^-1 M - I| {resid:.2e}")
    require(torch.isfinite(out).all() and err <= 1e-4,
            f"phase 10c: normal_inverse {err:.2e} from f64")
    del out, Mf, ref
    worst = witness("phase 10c witness", "normal_inverse",
                    lambda *a: (sk.normal_inverse(*a, sigma=sigma),),
                    lambda *a: (sk.normal_inverse_plain(*a, sigma),),
                    (qp.P, qp.A, rho), {}, ("inverse",), failures)
    extra["normal_inverse"].update(
        {"fleet": peaks, "rel_err_f64": err, "residual": resid,
         "witness_rel_err": worst,
         "device_launches_per_call": device_launches,
         "device_ms_by_kind": {k: ms for k, (_, ms) in split["normal_inverse"].items()},
         "witness_device_ms_by_kind": {
             k: ms for k, (_, ms) in split["normal_inverse_prev"].items()}})

    # 10d: phase 7a's solve at small B with TF32 on globally.
    lanes = pkg.QP(*(t[:64].contiguous() for t in qp.tensors()))
    del qp
    matmul = torch.backends.cuda.matmul
    sols, bare = {}, {}
    try:
        for tf32 in (False, True):
            matmul.allow_tf32 = tf32
            sols[tf32] = pkg.solve(lanes, st)
            bare[tf32] = torch.bmm(lanes.P[:4], lanes.P[:4])
            torch.cuda.synchronize()
    finally:
        matmul.allow_tf32 = False
    off, on = sols[False], sols[True]
    bare_dx = float((bare[True] - bare[False]).abs().max() / bare[False].abs().max())
    same = torch.equal(on.x, off.x) and torch.equal(on.info.iterations,
                                                    off.info.iterations)
    log(f"[phase 10d] B={lanes.P.shape[0]} defaults solve with allow_tf32 = "
        f"True: x bit for "
        f"bit the TF32-off x: {same} (a bare torch.bmm outside the solve "
        f"moves by {bare_dx:.2e} of its max with TF32 on)")
    if not same:
        failures.append("phase 10d: TF32 on changed the solve")
    require(not failures, "; ".join(failures))
    return launches


def sparse_problem(pkg):
    """Config 4 as benchmarks/large_sparse.py builds it: the generated
    problem, its 10 host Ruiz sweeps, and the scaled problem in ELL and in
    CSR storage (float32 on the card)."""
    import numpy as np

    from quadraticprogramsolver_tpu_torch.models.scaling import (
        equilibrate_sparse_host)

    t0 = time.perf_counter()
    data = pkg.generate_large_sparse_qp(SPARSE_N, seed=0)
    t1 = time.perf_counter()
    Ps, qs, As, ls, us, scal = equilibrate_sparse_host(
        data.P, data.q, data.A, data.l, data.u, 10, device=DEVICE)
    t2 = time.perf_counter()
    ell, csr = (pkg.make_sparse_qp(Ps, qs, As, ls, us, dtype=np.float32,
                                   storage=storage, device=DEVICE)
                for storage in ("ell", "bcoo"))
    import torch

    torch.cuda.synchronize()
    log(f"[phase 11] config 4: n={data.n} m={data.m} nnz(P)={data.P.nnz} "
        f"nnz(A)={data.A.nnz}; generated in {t1 - t0:.2f} s, Ruiz (10 "
        f"sweeps) {t2 - t1:.2f} s, ELL + CSR built on the card in "
        f"{time.perf_counter() - t2:.2f} s; ELL widths P {ell.P_vals.shape[1]}"
        f", A {ell.A_vals.shape[1]}, A' {ell.At_vals.shape[1]}")
    return data, scal, ell, csr


def sparse_solve(torch, pkg, cnt, qp, scal, st, label):
    """One counted solve, then the best of 3 (the counted run warms up).
    Returns (solution, seconds, launches, CG steps, host syncs): launches
    of ell_matvec and of the witness wrappers (ell_matvec_prev among them),
    which the counted run must leave at 0."""
    from quadraticprogramsolver_tpu_torch.models import admm, kkt

    pkg.solve(qp, st, scaling=scal)  # warm-up (cuSPARSE, allocator)
    torch.cuda.synchronize()
    reset(cnt)
    kkt._pcg.steps = kkt._pcg.syncs = admm._solve_core.syncs = 0
    sol = pkg.solve(qp, st, scaling=scal)
    torch.cuda.synchronize()
    launches = {"ell_matvec": cnt["ell_matvec"].launches,
                **read(cnt, (), label, witnesses=True)}
    steps, cg_syncs, check_syncs = (kkt._pcg.steps, kkt._pcg.syncs,
                                    admm._solve_core.syncs)
    syncs = cg_syncs + check_syncs
    dt = best_seconds(torch, lambda: pkg.solve(qp, st, scaling=scal), 3)
    iters = int(sol.info.iterations)
    log(f"[{label}] status {int(sol.info.status)}, outer iterations {iters}, "
        f"CG steps {steps} ({steps / max(iters, 1):.2f} per outer "
        f"iteration), host syncs {syncs} ({cg_syncs} in CG, {check_syncs} at "
        f"checks); solve {dt * 1e3:.2f} ms (best "
        f"of 3), {dt * 1e3 / max(iters, 1):.3f} ms per outer iteration; "
        f"ELL launches {launches['ell_matvec']}")
    return sol, dt, launches, steps, syncs


def osqp_f64(data, sol, label):
    """The OSQP criterion in f64 on the unscaled problem, at SPARSE_EPS:
    (passed, numbers)."""
    import numpy as np

    from quadraticprogramsolver_tpu_torch.utils.oracle import kkt_optimality

    x, z, y = (t.double().cpu().numpy() for t in (sol.x, sol.z, sol.y))
    rep = kkt_optimality(data.P, data.q, data.A, data.l, data.u, x, z, y)

    def inf(v):
        return float(np.abs(v).max())

    lim_p = SPARSE_EPS + SPARSE_EPS * max(inf(data.A @ x), inf(z))
    lim_d = SPARSE_EPS + SPARSE_EPS * max(inf(data.P @ x), inf(data.A.T @ y),
                                          inf(data.q))
    ok = (bool(np.isfinite(x).all() and np.isfinite(y).all())
          and rep.res_prim <= lim_p and rep.res_dual <= lim_d)
    log(f"[{label}] f64 on the unscaled problem: res_prim {rep.res_prim:.3e} "
        f"(limit {lim_p:.3e}), res_dual {rep.res_dual:.3e} (limit "
        f"{lim_d:.3e}), comp {rep.res_comp:.3e}, |Ax - z| {rep.res_z:.3e}: "
        f"{'pass' if ok else 'FAIL'}")
    return ok, {"res_prim": rep.res_prim, "lim_prim": lim_p,
                "res_dual": rep.res_dual, "lim_dual": lim_d,
                "res_comp": rep.res_comp, "res_z": rep.res_z}


def device_ms(fn, calls=20, reps=5):
    """Device time of one call of fn: CUDA events around ``calls``
    back-to-back calls queued behind a busy-wait kernel
    (``torch.cuda._sleep``), so that the host has queued them all before the
    first starts and the events time the device alone; around calls of a
    few microseconds they would time the host's launches (~0.02 ms a call).
    The median of ``reps`` groups after a warm-up group; a group whose
    busy-wait ended before its last call was queued is repeated with a
    longer one. ``fn`` may be a list of functions, called in turn (each on
    its own copy of the operands, from ``l2_copies``)."""
    import torch

    fns = fn if isinstance(fn, list) else [fn]
    cycles, times = 10_000_000, []
    for _ in range(reps + 1):
        while True:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            a.record()
            for i in range(calls):
                fns[i % len(fns)]()
            b.record()
            late = a.query()  # the device reached a: the host fell behind
            torch.cuda.synchronize()
            if not late:
                break
            cycles *= 2
            # A call that waits for the device (a host sync) is never
            # queued behind the busy-wait, however long it runs.
            require(cycles <= 10_000_000 * 2 ** 8,
                    "device_ms: the timed call synchronises with the device")
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times[1:])


def l2_copies(*tensors, touched=None):
    """Copies of ``tensors`` (dense or sparse CSR), enough that a call on
    each in turn reads its operands from device memory and not from the L2:
    together at least three times the L2's size, and at least 2. For a
    kernel that skips empty slots, ``touched`` (the bytes a call reads,
    far fewer than the tensors hold) counts in place of their size."""
    import torch

    def nbytes(t):
        if t.layout == torch.sparse_csr:
            return sum(a.nbytes for a in (t.values(), t.crow_indices(),
                                          t.col_indices()))
        return t.nbytes

    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    size = touched or sum(nbytes(t) for t in tensors)
    return [tuple(t.clone() for t in tensors)
            for _ in range(max(2, -(-3 * l2 // size)))]


def spmv_entry(name, launches, err, times, extra):
    src, rep = SPMV_KERNELS[name]
    ms, pms, lms, (bms, by) = times
    return {"name": name, "route": "cuda", "source": f"{PKG}/{src}",
            "replaces": rep, "stack": "phase 11", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "library_ms": lms, **extra}


def laplacian_2d(k):
    """The 2-D 5-point Laplacian on a k x k grid (n = k^2, about 5 nnz a
    row), scipy CSR float64."""
    import scipy.sparse as sp

    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    eye = sp.identity(k)
    return (sp.kron(eye, T) + sp.kron(T, eye)).tocsr()


def occupied_sectors(mask):
    """The 32-byte sectors of packed float32/int32 slots that hold a
    nonzero, from their occupancy mask (a byte of mask bits is 8
    consecutive slots, one sector when the rows are 8-slot aligned)."""
    import numpy as np

    return int(np.count_nonzero(mask.cpu().numpy().view(np.uint8)))


def routed_case(torch, rs, cnt, label, M, failures):
    """Rows 14b and 15 on the scipy matrix M (n x n): each kernel against
    its plain version and its witness, the whole matvecs against scipy in
    f64 (SPMV_SCIPY_BAR) in one counted call each, and their device times
    (from device memory, each call on the next of ``l2_copies``, and warm
    in the L2) beside the witness, the plain version, CSR M @ x (cuSPARSE)
    and two bounds: the bytes the redesigned kernel must move (masks,
    occupied sectors, index, x, y) and the bytes the first port streamed.
    Returns, by kernel name, its numbers."""
    import numpy as np

    from quadraticprogramsolver_tpu_torch.core.sparse_problem import _to_csr

    tag = f"phase 11d {label}"
    n, nnz = M.shape[1], M.nnz
    x_np = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    y_ref = M @ x_np.astype(np.float64)
    scale = float(np.abs(y_ref).max())
    x = torch.tensor(x_np, device=DEVICE)
    Mt = _to_csr(M, np.float32, DEVICE)
    csrs = l2_copies(Mt)
    lib = (device_ms([lambda a=a: a[0] @ x for a in csrs]),
           device_ms(lambda: Mt @ x))
    del csrs
    log(f"[{tag}] {M.shape[0]} x {n}, nnz {nnz}; CSR @ x {lib[0]:.4f} ms "
        f"from device memory, {lib[1]:.4f} ms warm")

    def against_scipy(what, y):
        rel = float(np.abs(y.double().cpu().numpy() - y_ref).max()) / scale
        log(f"[{tag}] {what}: max |y - scipy f64| / max|y| = {rel:.2e} "
            f"(bar {SPMV_SCIPY_BAR:.0e})")
        if not rel <= SPMV_SCIPY_BAR:
            failures.append(f"{tag} {what}: {rel:.2e} from scipy")
        return rel

    out = {}
    # Row 14b: route levels at S = 8, the probe's W.
    t0 = time.perf_counter()
    RL = rs.route_levels(M, ROUTE_S, rs.probe_width(n), DEVICE)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    G, T, S, W = RL.idxJ.shape
    slots = G * T * S * W
    sectors = occupied_sectors(RL.mask)
    t0 = time.perf_counter()
    n_tiles, _ = rs.chunk_tile_census(M, S)
    log(f"[{tag}] 14b route levels S={S} W={W}: T={T}, groups={G}, slots "
        f"{slots} ({slots / 1e6:.2f} M), fill {nnz / slots:.3f}, occupied "
        f"sectors {sectors} of {slots // 8} ({8 * sectors / slots:.3f}), "
        f"idxJ + V {(RL.idxJ.nbytes + RL.V.nbytes) / 1e6:.1f} MB, mask "
        f"{RL.mask.nbytes / 1e6:.2f} MB, packed in {pack_s:.2f} s; the "
        f"128-wide census: {n_tiles} tiles, {n_tiles / nnz:.2f} a nnz "
        f"({time.perf_counter() - t0:.2f} s)")
    X = torch.nn.functional.pad(x, (0, S * W - n)).reshape(W, S).T.contiguous()
    masked = rs.routed_levels_matvec(X, RL.idxJ, RL.V, RL.mask)
    dense = rs.routed_levels_matvec(X, RL.idxJ, RL.V)
    prev = rs.routed_levels_prev(X, RL.idxJ, RL.V)
    plain = rs.routed_levels_matvec_plain(X, RL.idxJ, RL.V)
    err = compare(f"{label} routed_levels (masked)", masked, plain, failures,
                  "phase 11d")
    err_prev = compare(f"{label} routed_levels_prev", prev, plain, failures,
                       "phase 11d")
    bits = {"masked": torch.equal(masked, prev),
            "unmasked": torch.equal(dense, prev)}
    log(f"[{tag}] routed_levels bit for bit routed_levels_prev: {bits}")
    if not all(bits.values()):
        failures.append(f"{tag} 14b: not bit for bit routed_levels_prev: {bits}")
    y, n14b = counted_call(torch, cnt, lambda: rs.routed_matvec(RL, x),
                           "routed_levels", f"{tag} 14b routed_matvec")
    n_prev = cnt["routed_levels_prev"].launches
    rel = against_scipy("routed_matvec", y)
    occ = 2 * 32 * sectors + RL.mask.nbytes + X.nbytes + G * W * 4
    streamed = RL.idxJ.nbytes + RL.V.nbytes + X.nbytes + G * W * 4
    b_occ, b_str = bound(occ, 2 * nnz), bound(streamed, 2 * slots)
    copies = l2_copies(RL.idxJ, RL.V, RL.mask, touched=occ)
    prev_ms, new_ms = in_turns(
        [lambda a=a: rs.routed_levels_prev(X, a[0], a[1]) for a in copies],
        [lambda a=a: rs.routed_levels_matvec(X, *a) for a in copies],
        device_ms)
    dense_ms = device_ms([lambda a=a: rs.routed_levels_matvec(X, a[0], a[1])
                          for a in copies])
    del copies
    warm = {"kernel": device_ms(
                lambda: rs.routed_levels_matvec(X, RL.idxJ, RL.V, RL.mask)),
            "unmasked": device_ms(
                lambda: rs.routed_levels_matvec(X, RL.idxJ, RL.V)),
            "prev": device_ms(lambda: rs.routed_levels_prev(X, RL.idxJ, RL.V)),
            "matvec": device_ms(lambda: rs.routed_matvec(RL, x))}
    plain_ms = device_ms(
        lambda: rs.routed_levels_matvec_plain(X, RL.idxJ, RL.V), calls=5)
    log(f"[{tag}] 14b from device memory: kernel {new_ms:.4f} ms "
        f"({new_ms * 1e6 / nnz:.4f} ns/nnz), unmasked {dense_ms:.4f} ms, "
        f"routed_levels_prev {prev_ms:.4f} ms ({prev_ms / new_ms:.2f}x, in "
        f"turns); warm in the L2: kernel {warm['kernel']:.4f} ms, unmasked "
        f"{warm['unmasked']:.4f}, prev {warm['prev']:.4f}, whole matvec "
        f"{warm['matvec']:.4f}; plain {plain_ms:.4f} ms; CSR @ x "
        f"{lib[0]:.4f} ms ({lib[1]:.4f} warm); bound {b_occ[0]:.4f} ms "
        f"(occupied sectors + mask, {b_occ[0] / new_ms:.2f} of it reached), "
        f"{b_str[0]:.4f} ms (streamed bytes)")
    common = {"T": T, "slots": slots, "fill": nnz / slots,
              "occupied_sectors": sectors,
              "occupied_share": 8 * sectors / slots, "pack_s": pack_s,
              "census_tiles_per_nnz": n_tiles / nnz, "rel_err_scipy": rel,
              "plain_ms": plain_ms, "library_ms": lib[0],
              "library_warm_ms": lib[1]}
    out["routed_levels"] = {
        "launches": n14b, "err": err,
        "times": (new_ms, plain_ms, lib[0], b_occ), "ms": new_ms,
        "warm_ms": warm["kernel"], "unmasked_ms": dense_ms,
        "unmasked_warm_ms": warm["unmasked"], "prev_ms": prev_ms,
        "matvec_ms": warm["matvec"], "bound_ms": b_occ[0],
        "bound_streamed_ms": b_str[0], "bits_prev": bits,
        "ns_per_slot": new_ms * 1e6 / slots, "ns_per_nnz": new_ms * 1e6 / nnz,
        **common}
    out["routed_levels_prev"] = {
        "launches": n_prev, "err": err_prev,
        "times": (prev_ms, plain_ms, lib[0], b_str), "ms": prev_ms,
        "warm_ms": warm["prev"], "bound_ms": b_str[0],
        "ns_per_slot": prev_ms * 1e6 / slots,
        "ns_per_nnz": prev_ms * 1e6 / nnz,
        "witness_of": WITNESSES["routed_levels_prev"], **common}
    del RL, X, y, masked, dense, prev, plain
    torch.cuda.empty_cache()

    # Row 15: row routed, fused (row_routed_blocks); its witness the first
    # port's rows kernel, then the block sum by index_add_.
    t0 = time.perf_counter()
    RR = rs.row_routed(M, DEVICE)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    R, Wd = RR.idx.shape
    slots = R * Wd
    n_used, n_blk = RR.order.numel(), RR.blk_ptr.numel() - 1
    sectors = occupied_sectors(RR.mask)
    log(f"[{tag}] 15 row routed: R={R} rows (L_max={RR.L}, {RR.n_win} "
        f"windows, {n_used} used), {n_blk} output blocks, slots {slots} "
        f"({slots / nnz:.1f}x nnz, fill {nnz / slots:.4f}), occupied sectors "
        f"{sectors} of {slots // 8} ({8 * sectors / slots:.4f}), idx + V "
        f"{(RR.idx.nbytes + RR.V.nbytes) / 1e6:.0f} MB, mask "
        f"{RR.mask.nbytes / 1e6:.2f} MB, packed in {pack_s:.2f} s")
    Xw = torch.nn.functional.pad(x, (0, RR.n_win * Wd - n)).reshape(RR.n_win, Wd)

    def fused(a=(RR.idx, RR.V, RR.mask, RR.order, RR.blk_ptr)):
        return rs.row_routed_blocks(Xw, *a, RR.L)

    def witness(a=(RR.idx, RR.V)):
        return rs.block_sum(rs.row_routed_rows(Xw, *a, RR.L), RR.order,
                            RR.blk_ptr)

    rows = rs.row_routed_rows(Xw, RR.idx, RR.V, RR.L)
    same_rows = torch.equal(rows, rs.row_routed_rows_plain(Xw, RR.idx, RR.V,
                                                           RR.L))
    err_rows = compare(f"{label} row_routed_rows", rows,
                       rs.row_routed_rows_plain(Xw, RR.idx, RR.V, RR.L),
                       failures, "phase 11d")
    del rows
    y1, y2, wit = fused(), fused(), witness()
    plain = rs.row_routed_blocks_plain(Xw, RR.idx, RR.V, RR.mask, RR.order,
                                       RR.blk_ptr, RR.L)
    err = compare(f"{label} row_routed_blocks", y1, plain, failures,
                  "phase 11d")
    det = torch.equal(y1, y2)
    wrel = float((y1 - wit).abs().max()) / max(float(wit.abs().max()), 1e-30)
    log(f"[{tag}] row_routed_rows bit for bit its plain version: {same_rows}; "
        f"row_routed_blocks two calls bit for bit: {det}; against the witness "
        f"(rows + index_add_): max |d| / max|y| = {wrel:.2e} (bar 1e-06)")
    if not (same_rows and det and wrel <= 1e-6):
        failures.append(f"{tag} 15: rows bit for bit {same_rows}, fused "
                        f"deterministic {det}, witness {wrel:.2e}")
    del y1, y2, wit, plain
    y, n15 = counted_call(torch, cnt, lambda: rs.row_routed_matvec(RR, x),
                          "row_routed_blocks", f"{tag} 15 row_routed_matvec")
    n_rows = cnt["row_routed_rows"].launches
    rel = against_scipy("row_routed_matvec", y)
    occ = (2 * 32 * sectors + n_used * 16 + RR.order.nbytes
           + RR.blk_ptr.nbytes + Xw.nbytes + n_blk * Wd * 4)
    streamed = RR.idx.nbytes + RR.V.nbytes + Xw.nbytes + slots * 4
    b_occ, b_str = bound(occ, 2 * nnz), bound(streamed, slots)
    copies = l2_copies(RR.idx, RR.V, RR.mask, RR.order, RR.blk_ptr,
                        touched=occ)
    new_ms = device_ms([lambda a=a: fused(a) for a in copies])
    del copies
    copies = l2_copies(RR.idx, RR.V)
    rows_ms = device_ms([lambda a=a: rs.row_routed_rows(Xw, *a, RR.L)
                         for a in copies])
    wit_ms = device_ms([lambda a=a: witness(a) for a in copies], calls=5)
    del copies
    warm = {"kernel": device_ms(fused),
            "matvec": device_ms(lambda: rs.row_routed_matvec(RR, x))}
    plain_ms = device_ms(lambda: rs.row_routed_blocks_plain(
        Xw, RR.idx, RR.V, RR.mask, RR.order, RR.blk_ptr, RR.L), calls=5)
    rows_plain_ms = device_ms(
        lambda: rs.row_routed_rows_plain(Xw, RR.idx, RR.V, RR.L), calls=5)
    log(f"[{tag}] 15 from device memory: kernel {new_ms:.4f} ms "
        f"({new_ms * 1e6 / nnz:.4f} ns/nnz); warm in the L2 {warm['kernel']:.4f}"
        f" ms, whole matvec {warm['matvec']:.4f} ms; the witness: rows "
        f"kernel {rows_ms:.4f} ms, rows + index_add_ {wit_ms:.4f} ms "
        f"({wit_ms / new_ms:.1f}x the kernel); plain {plain_ms:.4f} ms (rows "
        f"plain {rows_plain_ms:.4f}); CSR @ x {lib[0]:.4f} ms ({lib[1]:.4f} "
        f"warm); bound {b_occ[0]:.4f} ms (masks + occupied sectors + index, "
        f"{b_occ[0] / new_ms:.2f} of it reached), {b_str[0]:.4f} ms (streamed "
        f"bytes)")
    common = {"R": R, "L_max": RR.L, "used_rows": n_used, "slots": slots,
              "fill": nnz / slots, "occupied_sectors": sectors,
              "occupied_share": 8 * sectors / slots, "pack_s": pack_s,
              "rel_err_scipy": rel, "library_ms": lib[0],
              "library_warm_ms": lib[1]}
    out["row_routed_blocks"] = {
        "launches": n15, "err": err,
        "times": (new_ms, plain_ms, lib[0], b_occ), "ms": new_ms,
        "warm_ms": warm["kernel"], "matvec_ms": warm["matvec"],
        "witness_matvec_ms": wit_ms, "witness_rel_err": wrel,
        "deterministic": det, "bound_ms": b_occ[0],
        "bound_streamed_ms": b_str[0], "plain_ms": plain_ms,
        "ns_per_slot": new_ms * 1e6 / slots, "ns_per_nnz": new_ms * 1e6 / nnz,
        **common}
    out["row_routed_rows"] = {
        "launches": n_rows, "err": err_rows,
        "times": (rows_ms, rows_plain_ms, lib[0], b_str), "ms": rows_ms,
        "witness_matvec_ms": wit_ms, "bound_ms": b_str[0],
        "plain_ms": rows_plain_ms, "ns_per_slot": rows_ms * 1e6 / slots,
        "ns_per_nnz": rows_ms * 1e6 / nnz,
        "witness_of": WITNESSES["row_routed_rows"], **common}
    del RR, Xw, y
    torch.cuda.empty_cache()
    return out


def phase_sparse(torch, pkg, cnt, profile, config4=None):
    """Phase 11: config 4 on the card (11a ELL + CG, 11b CSR), row 13 alone
    (11c), rows 14a, 14b and 15 on P (11d). ``config4``: sparse_problem's
    result, built here when None. Returns their kernels-JSON entries."""
    import numpy as np

    from quadraticprogramsolver_tpu_torch.core.sparse_problem import _csr, _to_csr
    from quadraticprogramsolver_tpu_torch.ops import routed_spmv as rs, spmv

    failures = []
    data, scal, ell, csr = config4 or sparse_problem(pkg)
    st = pkg.Settings(**SPARSE_SETTINGS)
    p = pkg.plan(ell, st)
    require((p.backend, p.chunk, p.factor, p.cache, p.padded)
            == ("cg", "torch", "jacobi_diag", "diag", None),
            f"phase 11: unexpected plan {p}")

    # 11a: ELL storage, row 13 in every product.
    sol, dt, counts, steps, syncs = sparse_solve(
        torch, pkg, cnt, ell, scal, st, "phase 11a ELL")
    launches, launches_prev = counts["ell_matvec"], counts["ell_matvec_prev"]
    status, iters = int(sol.info.status), int(sol.info.iterations)
    checks = iters // st.check_interval
    expected = 3 + 5 * iters + 3 * steps + 3 * checks
    log(f"[phase 11a] ELL launches {launches}, the host loop's count 3 + 5 x "
        f"{iters} + 3 x {steps} + 3 x {checks} = {expected}")
    ok, f64 = osqp_f64(data, sol, "phase 11a")
    require(status == 3, f"phase 11a: status {status}, not SOLVED")
    require(ok, "phase 11a: the f64 OSQP criterion failed on the unscaled "
            "problem")
    require(0 < launches == expected, f"phase 11a: {launches} ELL launches, "
            f"the host loop says {expected}")
    solve_a = {"ms": dt * 1e3, "status": status, "iterations": iters,
               "cg_steps": steps, "host_syncs": syncs, "f64": f64}
    if profile:
        profile_solve(torch, lambda: pkg.solve(ell, st, scaling=scal),
                      "phase 11a profile")
    del sol

    # 11b: CSR storage (cuSPARSE): no kernel of ours.
    sol, dt_c, counts_c, steps_c, syncs_c = sparse_solve(
        torch, pkg, cnt, csr, scal, st, "phase 11b CSR")
    launches_c = counts_c["ell_matvec"]
    status_c = int(sol.info.status)
    ok_c, f64_c = osqp_f64(data, sol, "phase 11b")
    require(launches_c == 0, f"phase 11b: CSR storage launched the ELL "
            f"kernel {launches_c} times")
    require(status_c in (2, 3) and ok_c, f"phase 11b: status {status_c}, "
            f"f64 criterion {'passed' if ok_c else 'failed'}")
    solve_b = {"ms": dt_c * 1e3, "status": status_c,
               "iterations": int(sol.info.iterations), "cg_steps": steps_c,
               "host_syncs": syncs_c, "f64": f64_c}
    log(f"[phase 11] solve ELL {dt * 1e3:.2f} ms against CSR "
        f"{dt_c * 1e3:.2f} ms ({dt_c / dt:.2f}x)")
    del sol

    # 11c: row 13 alone on the solve's P, A and A', beside the kernel it
    # replaced (its witness, within LIMIT), its plain version and CSR @.
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    mats, worst, worst_prev = {}, 0.0, 0.0
    for name, vals, cols, M in (
            ("P", ell.P_vals, ell.P_cols, csr.P_csr),
            ("A", ell.A_vals, ell.A_cols, csr.A_csr),
            ("At", ell.At_vals, ell.At_cols, csr.At_csr)):
        v = torch.randn(M.shape[1], generator=g, device=DEVICE)
        rows, k = vals.shape
        nnz = M.values().numel()
        y_new = spmv.ell_matvec(vals, cols, v)
        y_prev = spmv.ell_matvec_prev(vals, cols, v)
        y_plain = spmv.ell_matvec_plain(vals, cols, v)
        err = compare(f"ell_matvec {name}", y_new, y_plain, failures,
                      "phase 11c")
        worst_prev = max(worst_prev, compare(
            f"ell_matvec_prev {name}", y_prev, y_plain, failures, "phase 11c"))
        compare(f"ell_matvec {name} against ell_matvec_prev", y_new, y_prev,
                failures, "phase 11c")
        worst = max(worst, err)
        out_in = v.nbytes + rows * 4
        nbytes = vals.nbytes + cols.nbytes + out_in
        # Device times read from device memory, as the bound assumes: each
        # call takes the next of several copies of the matrix, which
        # together overflow the L2 (v, 0.4 MB, stays in it, as in a solve).
        # "warm" times repeat the calls on one matrix, warm in the L2.
        ells, csrs = l2_copies(vals, cols), l2_copies(M)
        ms_prev, ms_new = in_turns(
            [lambda a=a: spmv.ell_matvec_prev(*a, v) for a in ells],
            [lambda a=a: spmv.ell_matvec(*a, v) for a in ells], device_ms)
        t = (ms_new,
             device_ms([lambda a=a: spmv.ell_matvec_plain(*a, v)
                        for a in ells], calls=5),
             device_ms([lambda a=a: a[0] @ v for a in csrs]),
             bound(nbytes, 2 * rows * k))
        warm = {"ell_matvec": device_ms(lambda: spmv.ell_matvec(vals, cols, v)),
                "ell_matvec_prev": device_ms(
                    lambda: spmv.ell_matvec_prev(vals, cols, v)),
                "csr": device_ms(lambda: M @ v)}
        del ells, csrs
        # A call's cost as the solve's host loop sees it: CUDA events around
        # 20 back-to-back calls (the host's launch cost fills the gaps).
        call_ms = {"ell_matvec": cuda_ms(lambda: spmv.ell_matvec(vals, cols, v),
                                         inner=20),
                   "csr": cuda_ms(lambda: M @ v, inner=20)}
        nnz_bound = (nnz * 8 + out_in) / PEAK_BYTES_S * 1e3
        mats[name] = {"shape": [rows, k], "nnz": nnz, "ms": t[0],
                      "prev_ms": ms_prev, "plain_ms": t[1], "library_ms": t[2],
                      "bound_ms": t[3][0], "nnz_bound_ms": nnz_bound,
                      "warm_ms": warm, "call_ms": call_ms}
        log(f"[phase 11c] ell_matvec {name} ({rows} x {k}, nnz {nnz}, fill "
            f"{nnz / (rows * k):.2f}), device times from device memory: "
            f"kernel {t[0]:.4f} ms, ell_matvec_prev {ms_prev:.4f} ms "
            f"({ms_prev / t[0]:.2f}x, in turns), plain {t[1]:.4f} ms, CSR @ "
            f"{t[2]:.4f} ms; bound {t[3][0]:.4f} ms (ELL bytes as stored, "
            f"{t[3][0] / t[0]:.2f} of it reached), {nnz_bound:.4f} ms (nnz "
            f"only); warm in the L2: kernel {warm['ell_matvec']:.4f} ms, "
            f"ell_matvec_prev {warm['ell_matvec_prev']:.4f} ms, CSR @ "
            f"{warm['csr']:.4f} ms; a call with the host's cost: kernel "
            f"{call_ms['ell_matvec']:.4f} ms, CSR @ {call_ms['csr']:.4f} ms")
        if name == "P":
            times_p, times_prev = t, (ms_prev, *t[1:])
    entries = [spmv_entry("ell_matvec", launches, worst, times_p,
                          {"stack": "phase 11a", "matrices": mats,
                           "warm_ms": mats["P"]["warm_ms"]["ell_matvec"],
                           "solve_ell": solve_a, "solve_csr": solve_b}),
               spmv_entry("ell_matvec_prev", launches_prev, worst_prev,
                          times_prev,
                          {"witness_of": WITNESSES["ell_matvec_prev"],
                           "warm_ms": mats["P"]["warm_ms"]["ell_matvec_prev"],
                           "stack": "phase 11a"})]

    # 11d: the probes' routed matvecs on P (unscaled, as the probes pack it),
    # then rows 14b and 15 on a banded matrix, where routing should pay.
    Pc = data.P.tocsr()

    # Row 14a: the square micro kernel (one level) on every probe shape. At
    # T = 1 without a mask routed_levels_matvec launches the first port's
    # kernel (routed_levels_prev_kernel); beside it, bit for bit, the
    # level-split kernel that the dispatch passes over there, run by a
    # full occupancy mask.
    micro = {}
    for S, W, G in MICRO_SHAPES:
        X = torch.randn((S, W), generator=g, device=DEVICE)
        idx = torch.randint(0, W, (G, S, W), generator=g, device=DEVICE,
                            dtype=torch.int32)
        V = torch.randn((G, S, W), generator=g, device=DEVICE)
        full = torch.full((G, S, W // 32), -1, dtype=torch.int32,
                          device=DEVICE).view(torch.uint32)
        slots = G * S * W
        tag = f"S={S} W={W} G={G}"
        k = rs.routed_levels_matvec(X, idx, V)
        err = compare(f"routed_levels_t1 {tag}", k,
                      rs.routed_levels_matvec_plain(X, idx, V), failures,
                      "phase 11d")
        same = torch.equal(k, rs.routed_levels_matvec(X, idx, V, full))
        if not same:
            failures.append(f"phase 11d 14a {tag}: the level-split kernel "
                            "not bit for bit routed_levels_prev_kernel")
        # The same function as one CSR product: row g*W + l holds V[g, s, l]
        # at column s*W + idx[g, s, l] of X's rows laid end to end.
        col = (torch.arange(S, device=DEVICE)[None, :, None] * W + idx)
        M = _csr(torch.arange(0, G * W * S + 1, S, device=DEVICE),
                 col.permute(0, 2, 1).reshape(-1).long(),
                 V.permute(0, 2, 1).reshape(-1), (G * W, S * W))
        del col
        Xf = X.reshape(-1)
        split_ms, new_ms = in_turns(
            lambda: rs.routed_levels_matvec(X, idx, V, full),
            lambda: rs.routed_levels_matvec(X, idx, V), device_ms)
        t = (new_ms, device_ms(lambda: rs.routed_levels_matvec_plain(X, idx, V),
                               calls=5),
             device_ms(lambda: M @ Xf),
             bound(idx.nbytes + V.nbytes + X.nbytes + G * W * 4, 2 * slots))
        micro[tag] = {"ms": t[0], "level_split_ms": split_ms,
                      "plain_ms": t[1], "library_ms": t[2],
                      "bound_ms": t[3][0], "ns_per_slot": t[0] * 1e6 / slots,
                      "max_abs_err": err, "bits_level_split": same}
        log(f"[phase 11d] 14a {tag}: kernel (routed_levels_prev_kernel) "
            f"{t[0]:.4f} ms ({t[0] * 1e6 / slots:.4f} ns/slot), the "
            f"level-split kernel (full mask) {split_ms:.4f} ms "
            f"({split_ms / t[0]:.3f}x, in turns; bit for bit: {same}), plain "
            f"{t[1]:.4f} ms, CSR @ {t[2]:.4f} ms, bound {t[3][0]:.4f} ms")
        if (S, W, G) == MICRO_MAIN:
            _, n14a = counted_call(
                torch, cnt, lambda: rs.routed_levels_matvec(X, idx, V),
                "routed_levels", "phase 11d 14a")
            entries.append(spmv_entry("routed_levels_t1", n14a, err, t, {
                "kernel": "routed_levels_prev_kernel",
                "shape": {"S": S, "W": W, "G": G},
                "level_split_ms": split_ms, "micro": micro}))
        del X, idx, V, M, Xf, full
    torch.cuda.empty_cache()

    res = {"P": routed_case(torch, rs, cnt, "P", Pc, failures)}
    res["banded"] = routed_case(torch, rs, cnt, "banded", laplacian_2d(BAND_K),
                                failures)
    for name in ("routed_levels", "routed_levels_prev", "row_routed_blocks",
                 "row_routed_rows"):
        e = res["P"][name]
        entries.append(spmv_entry(name, e.pop("launches"), e.pop("err"),
                                  e.pop("times"), {
                                      **e, "library_call": "CSR P @ x",
                                      "banded": {k: v for k, v in
                                                 res["banded"][name].items()
                                                 if k != "times"}}))
    require(not failures, "; ".join(failures))
    return entries


# --- Phase 12: the rest of the ADMM core -----------------------------------

#: 12a: benchmarks/sweep_classes.py's shape and settings (n=128, the capped
#: families at m=128, every class padded to the sweep's (512, 384)).
CLASS_N, CLASS_B, CLASS_PAD = 128, 256, (512, 384)
CAPPED = ("lasso", "huber", "svm", "inequality_qp")
#: The sweep's eps, then one tighter step for a class whose x audit fails.
CLASS_EPS = (1e-4, 1e-6)
#: A class whose x f32 cannot bring within the target at any of CLASS_EPS
#: is held to FLOOR_FACTOR times it, or to its objective within it.
FLOOR_FACTOR = 10
SWEEP_SETTINGS = dict(max_iterations=4000, eps_abs=1e-4, eps_rel=1e-4,
                      rho=0.1, adaptive_rho=True, kkt_refinement_steps=2,
                      scaling_iters=10, fused_chunk=True, require_fused=True)
#: 12b: examples/anderson_acceleration.py's family and settings at B=1024,
#: eps 1e-4, with the fused M^{-1} chunk (the fleet pads to 128 x 1024).
AA_B, AA_N = 1024, 100
AA_SETTINGS = dict(max_iterations=4000, eps_abs=1e-4, eps_rel=1e-4, rho=0.1,
                   check_interval=25, fused_chunk=True, require_fused=True)
AA_MEMORY = 8
#: 12d: examples/mpc_fleet.py's headline-scale ticks.
MPC_H, MPC_B, MPC_T, MPC_UMAX = 512, 2048, 8, 3.0
MPC_SETTINGS = dict(max_iterations=1000, eps_abs=1e-4, eps_rel=1e-4, rho=0.4,
                    adaptive_rho=False, check_interval=12)
#: The kernels phase 12's runs may launch (its paths line).
CORE_KERNELS = ("slab_build", "pivot_sweep_v3", "slab_level", "admm_chunk",
                "admm_chunk_minv", "prox_chunk", "prox_chunk_minv")


def core_counts(cnt, path, label):
    """``read`` of one phase-12 run: the path's kernels must have launched
    and no witness; returns every CORE_KERNELS count."""
    read(cnt, path, label)
    return {k: cnt[k].launches for k in CORE_KERNELS}


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def minv_kernel_line(cnt, n, m, refine, label):
    """Which kernel ran the M^{-1} chunk (the dispatch rule's, printed)."""
    from quadraticprogramsolver_tpu_torch.ops import fused_admm

    want = fused_admm.minv_chunk_kernel(n, m, 1, refine)
    variants = dict(cnt["admm_chunk_minv"].variants)
    log(f"[{label}] admm_chunk_minv launches by variant {variants}: the "
        f"rule sends a lane at ({n}, {m}), refine {refine}, to the "
        f"{'cluster' if want == 'cluster' else 'streaming'} kernel")
    cluster = sum(v for k, v in variants.items() if k.endswith(",cluster"))
    require((cluster > 0) == (want == "cluster")
            and cnt["admm_chunk_minv"].launches > 0,
            f"{label}: the M^-1 chunk did not run the {want} kernel")


def audit_lanes(qp, x, status, iters, label, k=4, n=None, m=None,
                required=True, pool=None):
    """f64_oracle on k spread and the k straggling converged lanes (the most
    iterations), on the lanes' first n variables and m rows (the problem
    before its pad). Returns (max |x - x_ref|_inf, the largest objective
    gap |f(x) - f(x_ref)| / max(1, |f(x_ref)|)); with ``required`` the
    phase-3 rule, the x deviation within the target, must hold."""
    import numpy as np

    conv = np.where((status == 2) | (status == 3))[0]
    require(len(conv) > 0, f"{label}: no lane converged")
    spread = conv[np.linspace(0, len(conv) - 1, k).astype(int)]
    worst = conv[np.argsort(iters[conv], kind="stable")[-k:]]
    idx = sorted(set(spread.tolist()) | set(worst.tolist()))
    n = qp.n if n is None else n
    m = qp.m if m is None else m
    devs, gaps = [], []
    lanes = []
    for i in idx:
        P, q, A, l, u = (t[i].double().cpu().numpy() for t in qp.tensors())
        lanes.append((P[:n, :n], q[:n], A[:m, :n], l[:m], u[:m]))
    refs = oracle_solves(lanes, pool, eps_abs=1e-6, eps_rel=1e-6, rho=0.1,
                         max_iterations=20000)
    for i, (P, q, A, l, u), ref in zip(idx, lanes, refs):
        require(ref.status == 3, f"{label}: oracle did not converge on lane {i}")
        xi = x[i, :n]
        devs.append(float(np.abs(xi - ref.x).max()))
        f, f_ref = (0.5 * v @ P @ v + q @ v for v in (xi, ref.x))
        gaps.append(abs(f - f_ref) / max(1.0, abs(f_ref)))
    worst_dev = max(devs)
    log(f"[{label}] audit max|x - x_ref|_inf over lanes {idx} = "
        f"{worst_dev:.3e} (target {AUDIT_TARGET:.0e}), objective gap "
        f"{max(gaps):.3e}")
    require(not required or worst_dev <= AUDIT_TARGET,
            f"{label}: audit {worst_dev:.3e} > {AUDIT_TARGET:.0e}")
    return worst_dev, max(gaps)


def stats_line(sol):
    import numpy as np

    status = sol.info.status.cpu().numpy()
    iters = sol.info.iterations.cpu().numpy()
    solved = int(((status == 2) | (status == 3)).sum())
    return status, iters, solved, (f"solved {solved}/{status.size}, "
                                   f"iterations p50 {np.median(iters):.0f} "
                                   f"max {iters.max()} total {iters.sum()}")


def phase_core_classes(torch, pkg, cnt, pool):
    """12a: Ruiz scaling over the 9 classes, then on phase 3's stack."""
    import dataclasses

    import numpy as np

    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)

    settings = pkg.Settings(**SWEEP_SETTINGS)
    total = {}
    for cls in pkg.ALL_CLASSES:
        label = f"phase 12a {cls.value}"
        t0 = time.perf_counter()
        fleet = pkg.generate_batch(cls, CLASS_B, CLASS_N,
                                   CLASS_N if cls.value in CAPPED else 0,
                                   seed=0, dtype=np.float32, device=DEVICE)
        n0, m0 = fleet.n, fleet.m
        qp = pkg.pad_qp(fleet, *CLASS_PAD)
        del fleet
        gen_s = time.perf_counter() - t0
        p = pkg.plan(qp, settings)
        require((p.factor, p.chunk, p.padded) == ("sweep_inverse",
                                                   "fused_kernel", None),
                f"{label}: unexpected plan {p}")
        # The sweep's eps first (timed), then tighter while the x audit
        # fails: x's distance to the oracle is not what eps bounds, and on
        # the ill-conditioned classes 1e-4 residuals leave x 1e-3 away.
        for eps in CLASS_EPS:
            st = dataclasses.replace(settings, eps_abs=eps, eps_rel=eps)
            tag = f"{label}, eps {eps:.0e}"
            reset(cnt)
            sol = pkg.solve(qp, st)
            torch.cuda.synchronize()
            counts = core_counts(cnt, ADMM_MINV_PATH, tag)
            minv_kernel_line(cnt, *CLASS_PAD, 2, tag)
            require(counts["pivot_sweep_v3"] % LEVELS == 0,
                    f"{tag}: {counts['pivot_sweep_v3']} pivot launches, not "
                    f"{LEVELS} a factor")
            add_counts(total, counts)
            timed = ""
            if eps == settings.eps_abs:
                best = best_seconds(torch, lambda: pkg.solve(qp, st), reps=3)
                timed = (f", solve {best * 1e3:.2f} ms (best of 3 after a "
                         "warm call)")
            status, iters, solved, line = stats_line(sol)
            x = sol.x.double().cpu().numpy()
            require(bool(np.isfinite(x).all()), f"{tag}: non-finite x")
            log(f"[{tag}] ({n0}, {m0}) padded to {CLASS_PAD}, generated in "
                f"{gen_s:.1f} s: {line}{timed}, factors "
                f"{counts['pivot_sweep_v3'] // LEVELS}, M^-1 chunk launches "
                f"{counts['admm_chunk_minv']}")
            del sol
            log(f"[{tag}] {time.perf_counter() - t0:.1f} s into the class")
            if 2 * solved < CLASS_B and eps != CLASS_EPS[0]:
                log(f"[{tag}] most lanes do not converge in f32: the audit "
                    "stays at the last eps")
                break
            dev, gap = audit_lanes(qp, x, status, iters, tag, n=n0, m=m0,
                                   required=False, pool=pool)
            if dev <= AUDIT_TARGET:
                break
        if dev > AUDIT_TARGET:
            # f32's floor on this class: x stays apart from the oracle at
            # every eps f32 reaches (isotonic lanes stall at the fixed point
            # ~2e-4 away, as the JAX package's f32 solve does; huber's x is
            # not fixed to 1e-4 by its objective). Then x within
            # FLOOR_FACTOR times the target, or the objective within it.
            log(f"[{label}] x audit {dev:.3e} above {AUDIT_TARGET:.0e} at the "
                f"tightest eps f32 reaches; objective gap {gap:.3e}: the f32 "
                f"floor rule (x within {FLOOR_FACTOR * AUDIT_TARGET:.0e} or "
                f"the objective within {AUDIT_TARGET:.0e})")
            require(dev <= FLOOR_FACTOR * AUDIT_TARGET or gap <= AUDIT_TARGET,
                    f"{label}: x audit {dev:.3e}, objective gap {gap:.3e}")
        del qp
    # Rows 1 and 3 (and 2, 4a) on a Ruiz-scaled problem: phase 3's stack.
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    qp = device_random_qp_fleet(B_MAIN, N, M, generator=g)
    base = dict(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4, rho=0.4,
                check_interval=11, kkt_refinement_steps=0, sigma_free_rhs=True,
                fused_factor=True, fused_chunk=True, require_fused=True,
                adaptive_rho=False, scaling_iters=10)
    label = "phase 12a phase-3 stack, scaling_iters 10"
    for eps in (1e-4, 2e-5, 1e-5):
        settings = pkg.Settings(**{**base, "eps_abs": eps, "eps_rel": eps})
        reset(cnt)
        sol = pkg.solve(qp, settings)
        torch.cuda.synchronize()
        counts = core_counts(cnt, ADMM_PATH, f"{label}, eps {eps:.0e}")
        factor_kernels(cnt, label)
        x, status, iters = report_solve(qp, sol, None, None,
                                        f"{label}, eps {eps:.0e}")
        del sol
        dev = audit(qp, x, status, iters, f"{label}, eps {eps:.0e}",
                    required=False, prefix="phase 12a", pool=pool)
        if dev <= AUDIT_TARGET:
            break
    require(dev <= AUDIT_TARGET, f"{label}: audit {dev:.3e} at eps 1e-5")
    best = best_seconds(torch, lambda: pkg.solve(qp, settings), reps=3)
    log(f"[{label}, eps {eps:.0e}] solve {best * 1e3:.2f} ms (best of 3 "
        "after a warm call)")
    add_counts(total, counts)
    return total


class AcceptCount:
    """Counts the Anderson mixes offered and accepted (lanes running with a
    history) through ``owner.name``, summed on the device."""

    def __init__(self, torch, owner, name, prox):
        self.owner, self.name = owner, name
        self.orig = getattr(owner, name)
        self.offered = self.accepted = 0

        def counted(*a, **k):
            if prox:
                aa, active = a[2], a[4]
            else:
                aa, active = a[2].aa, a[2].status == 0
            out = self.orig(*a, **k)
            self.offered += (active & (aa["count"] >= 1)).sum()
            self.accepted += out[-1].sum()
            return out

        setattr(owner, name, counted)

    def share(self):
        off = int(self.offered)
        return int(self.accepted) / off if off else 0.0, off

    def close(self):
        setattr(self.owner, self.name, self.orig)


def phase_core_anderson(torch, pkg, cnt, pool):
    """12b: Anderson acceleration of both families, 0 beside 8."""
    import dataclasses

    import numpy as np

    from quadraticprogramsolver_tpu_torch.models import anderson
    from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
        device_prox_fleet)

    t0 = time.perf_counter()
    qp = pkg.generate_batch(pkg.ProblemClass.INEQUALITY_QP, AA_B, AA_N,
                            seed=0, dtype=np.float32, device=DEVICE)
    log(f"[phase 12b] INEQUALITY_QP fleet B={AA_B}, n={qp.n}, m={qp.m} "
        f"generated in {time.perf_counter() - t0:.1f} s")
    total = {}
    base = pkg.Settings(**AA_SETTINGS)
    n_pad, m_pad = pkg.plan(qp, base).padded
    for mem in (0, AA_MEMORY):
        # The example's eps (timed), then tighter while the audit fails.
        for eps in (1e-4, 1e-5):
            st = dataclasses.replace(base, anderson_memory=mem, eps_abs=eps,
                                     eps_rel=eps)
            label = f"phase 12b anderson_memory={mem}, eps {eps:.0e}"
            acc = AcceptCount(torch, anderson, "aa_step", prox=False)
            try:
                reset(cnt)
                sol = pkg.solve(qp, st)
                torch.cuda.synchronize()
            finally:
                acc.close()
            counts = core_counts(cnt, ADMM_MINV_PATH, label)
            minv_kernel_line(cnt, n_pad, m_pad, 1, label)
            add_counts(total, counts)
            timed = ""
            if eps == base.eps_abs:
                best = best_seconds(torch, lambda: pkg.solve(qp, st), reps=3)
                timed = f", solve {best * 1e3:.2f} ms (best of 3 after a warm call)"
            status, iters, solved, line = stats_line(sol)
            share, offered = acc.share()
            log(f"[{label}] {line}, mixes accepted {share:.3f} of "
                f"{offered}{timed}")
            require(solved == AA_B, f"{label}: {AA_B - solved} lanes unsolved")
            dev, _ = audit_lanes(qp, sol.x.double().cpu().numpy(), status,
                                 iters, label, required=False, pool=pool)
            del sol
            if dev <= AUDIT_TARGET:
                break
        require(dev <= AUDIT_TARGET, f"{label}: audit {dev:.3e}")
    st = dataclasses.replace(base, anderson_memory=AA_MEMORY,
                             record_history=True)
    sol = pkg.solve(qp, st)
    h = sol.info.history
    ran = int(sol.info.iterations.max()) // st.check_interval
    shapes = {k: tuple(v.shape) for k, v in h.items()}
    log(f"[phase 12b record_history] history {shapes}, {ran} checks run of "
        f"{st.num_checks}")
    require(all(s == (st.num_checks, AA_B) for s in shapes.values())
            and all(bool(v[:ran].isfinite().all()) and bool(v[ran:].isinf().all())
                    for v in h.values()),
            "phase 12b: the history is not finite up to the last check and "
            "inf after")
    del sol, qp

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    prob = device_prox_fleet(AA_B, N, ME, MI, generator=g)
    for mem in (0, AA_MEMORY):
        for eps in (1e-4, 5e-5, 2e-5, 1e-5):
            st = pkg.ProxQPSettings(
                max_iterations=2000, eps_abs=eps, eps_rel=eps, rho=0.0125,
                adaptive_rho=False, check_interval=25, kkt_warm_start=False,
                kkt_refinement_steps=0, sigma_free_rhs=True, fused_chunk=True,
                require_fused=True, anderson_memory=mem)
            label = f"phase 12b prox anderson_memory={mem}, eps {eps:.0e}"
            acc = AcceptCount(torch, anderson, "aa_step_proxqp", prox=True)
            try:
                reset(cnt)
                sol = pkg.solve_proxqp(prob, st)
                torch.cuda.synchronize()
            finally:
                acc.close()
            counts = core_counts(cnt, PROX_PATH, label)
            best = best_seconds(torch, lambda: pkg.solve_proxqp(prob, st),
                                reps=3)
            _, _, solved, line = stats_line(sol)
            share, offered = acc.share()
            log(f"[{label}] {line}, mixes accepted {share:.3f} of {offered}, "
                f"solve {best * 1e3:.2f} ms (best of 3 after a warm call)")
            report_prox(prob, sol, None, None, label)
            dev = prox_audit(pkg, prob, sol, label, pool)
            del sol
            if dev <= AUDIT_TARGET:
                break
        require(dev <= AUDIT_TARGET, f"{label}: audit {dev:.3e}")
        add_counts(total, counts)
    return total


def phase_core_polish(torch, pkg, cnt, pool):
    """12c: polish on phase 7a's fleet and settings."""
    import numpy as np

    from quadraticprogramsolver_tpu_torch.models import admm, polish
    from quadraticprogramsolver_tpu_torch.ops import spd_kernels
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    qp = device_random_qp_fleet(B_DEFAULTS, N, M, generator=g)
    st = pkg.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4,
                      polish_iterations=3)
    seen = {}
    orig = admm.polish_fn

    def watched(qp_, settings, x, z, y, rho):
        before = spd_kernels.spd_inverse_unrolled.launches
        out = orig(qp_, settings, x, z, y, rho)
        seen.update(x=x, y=y, out=out, launches=(
            spd_kernels.spd_inverse_unrolled.launches - before))
        return out

    label = "phase 12c polish_iterations=3"
    admm.polish_fn = watched
    try:
        reset(cnt)
        sol = pkg.solve(qp, st)
        torch.cuda.synchronize()
    finally:
        admm.polish_fn = orig
    counts = core_counts(cnt, ADMM_DEFAULTS_PATH, label)
    x_out, y_out = seen["out"]
    accepted = (x_out != seen["x"]).any(-1)
    err0 = polish._kkt_error(qp, seen["x"], seen["y"]).cpu().numpy()
    err1 = polish._kkt_error(qp, x_out, y_out).cpu().numpy()
    factor = counts["pivot_sweep_v3"] - seen["launches"]
    log(f"[{label}] row 2 launches: {counts['pivot_sweep_v3']} "
        f"({factor} in {factor // LEVELS} factor builds, {seen['launches']} "
        f"in the polish: H at n={N}, S at m={M}); lanes accepted "
        f"{float(accepted.float().mean()):.3f}; KKT error p50 "
        f"{np.median(err0):.3e} before, {np.median(err1):.3e} after "
        f"(accepted lanes: {np.median(err0[accepted.cpu().numpy()]):.3e} -> "
        f"{np.median(err1[accepted.cpu().numpy()]):.3e})")
    require(seen["launches"] == N // 128 + M // 128,
            f"{label}: {seen['launches']} pivot launches in the polish, not "
            f"{N // 128} + {M // 128}")
    require(bool(accepted.any()), f"{label}: no lane accepted its polish")
    require(bool((err1 <= err0).all()), f"{label}: a lane's KKT error grew")
    best = best_seconds(torch, lambda: pkg.solve(qp, st), reps=3)
    x, status, iters = report_solve(qp, sol, None, None, label)
    log(f"[{label}] solve {best * 1e3:.2f} ms (best of 3 after a warm call)")
    del sol
    audit(qp, x, status, iters, label, prefix="phase 12c", pool=pool)
    return counts


def mpc_fleet(torch, pkg):
    """examples/mpc_fleet.py's headline-scale problem: P and A stored once,
    q drifting 0.02 a tick."""
    import numpy as np

    rng = np.random.default_rng(2)
    Mr = rng.standard_normal((MPC_H, MPC_H)).astype(np.float32)
    P = Mr @ Mr.T / MPC_H + 0.01 * np.eye(MPC_H, dtype=np.float32)
    rng.standard_normal((MPC_B, MPC_H))  # the example's first q (unused)
    q0 = rng.standard_normal((MPC_B, MPC_H)).astype(np.float32)
    dq = rng.standard_normal((MPC_T, MPC_B, MPC_H)).astype(np.float32) * 0.02
    q_seq = torch.as_tensor(q0[None] + np.cumsum(dq, axis=0), device=DEVICE)
    full = torch.full((MPC_B, MPC_H), MPC_UMAX, device=DEVICE)
    qp = pkg.QP(P=torch.as_tensor(P, device=DEVICE), q=q_seq[0],
                A=torch.eye(MPC_H, device=DEVICE), l=-full, u=full)
    return qp, q_seq


def phase_core_reuse(torch, pkg, cnt, pool):
    """12d: factor reuse at the MPC fleet's ticks, then a prepared solve of
    phase 3's fleet at its sigma-free stack."""
    import dataclasses

    from quadraticprogramsolver_tpu_torch.frontends.sequence import (
        solve_sequence_vectors)
    from quadraticprogramsolver_tpu_torch.ops import fused_admm
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)

    qp, q_seq = mpc_fleet(torch, pkg)
    st = pkg.Settings(**MPC_SETTINGS)
    total = {}

    def naive():
        warm, out = (None, None, None), []
        for t in range(MPC_T):
            sol = pkg.solve(dataclasses.replace(qp, q=q_seq[t]), st, *warm)
            warm = (sol.x, sol.z, sol.y)
            out.append(sol)
        return out

    solver = None

    def cached():
        out = []
        for t in range(MPC_T):
            solver.update(q=q_seq[t])
            out.append(solver.solve(warm_start=t > 0))
        return out

    def ticks(sols, label):
        iters = [int(s.info.iterations.max()) for s in sols]
        p50 = [float(s.info.iterations.float().median()) for s in sols]
        ok = all(bool((s.info.status >= 2).all()) for s in sols)
        log(f"[{label}] iterations a tick: max {iters}, p50 {p50}")
        require(ok, f"{label}: a tick ended below status 2")

    walls = {}
    for name in ("naive", "cached", "vectors_per_tick", "vectors_reuse"):
        label = f"phase 12d {name}"
        if name == "cached":
            reset(cnt)
            solver = pkg.CachedQPSolver(qp, st)
            torch.cuda.synchronize()
            setup = cnt["pivot_sweep_v3"].launches
            log(f"[{label}] setup: {setup} pivot launches")
            require(setup == MPC_H // 128, f"{label}: setup ran {setup} "
                    f"pivot launches, not {MPC_H // 128}")
            run = cached
        elif name == "naive":
            run = naive
        else:
            reuse = name == "vectors_reuse"

            def run(reuse=reuse):
                return [solve_sequence_vectors(qp, q_seq, settings=st,
                                               reuse_factor=reuse)]
        reset(cnt)
        sols = run()
        torch.cuda.synchronize()
        launches = {k: cnt[k].launches for k in CORE_KERNELS}
        piv = launches["pivot_sweep_v3"]
        want = {"naive": MPC_T * MPC_H // 128, "cached": 0,
                "vectors_per_tick": MPC_T * MPC_H // 128,
                "vectors_reuse": MPC_H // 128}[name]
        log(f"[{label}] pivot launches {piv} over {MPC_T} ticks")
        require(piv == want, f"{label}: {piv} pivot launches, not {want}")
        add_counts(total, launches)
        t0 = time.perf_counter()
        sols = run()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        if name.startswith("vectors"):
            s = sols[0]
            sols = [dataclasses.replace(s, x=s.x[t], info=dataclasses.replace(
                s.info, status=s.info.status[t],
                iterations=s.info.iterations[t])) for t in range(MPC_T)]
        ticks(sols, label)
        if name == "naive":
            x_naive = sols[-1].x
        elif name == "cached":
            x_cached = sols[-1].x
        del sols
    dev = float((x_cached - x_naive).abs().max())
    log(f"[phase 12d] walls over {MPC_T} ticks (H={MPC_H}, B={MPC_B}): "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in walls.items())
        + f"; naive/cached {walls['naive'] / walls['cached']:.2f}x; final "
        f"tick max|x_cached - x_naive| {dev:.3e}")
    del qp, q_seq, solver

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    qp = device_random_qp_fleet(B_MAIN, N, M, generator=g)
    st = pkg.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4,
                      rho=0.4, check_interval=11, kkt_refinement_steps=0,
                      sigma_free_rhs=True, fused_factor=True, fused_chunk=True,
                      require_fused=True, adaptive_rho=False)
    reset(cnt)
    prep = pkg.prepare(qp, st)
    torch.cuda.synchronize()
    setup = cnt["pivot_sweep_v3"].launches
    p = pkg.plan(qp, st, prepared=True)
    require((p.factor, p.cache, p.chunk) == ("prepared", "G_g", "fused_kernel"),
            f"phase 12d prepared: unexpected plan {p}")
    # Phase 3's eps (timed), then tighter while the audit fails; the factor
    # is prepared once for all of them (it does not depend on eps).
    for eps in (1e-4, 2e-5, 1e-5):
        st = dataclasses.replace(st, eps_abs=eps, eps_rel=eps)
        label = f"phase 12d prepared phase-3 solve, eps {eps:.0e}"
        reset(cnt)
        sol = pkg.solve(qp, st, prepared=prep)
        torch.cuda.synchronize()
        counts = core_counts(cnt, ("admm_chunk",), label)
        split = chunk_kernels(cnt, "admm_chunk", fused_admm.chunk_kernel(
            N, M, 1, "highest", "G"), label)
        log(f"[{label}] prepare: {setup} pivot launches; the solve: no "
            f"factor kernel ({counts['slab_build']} builds, "
            f"{counts['pivot_sweep_v3']} pivot launches), chunk launches "
            f"{split}")
        require(counts["slab_build"] == counts["pivot_sweep_v3"] == 0,
                f"{label}: the prepared solve factored")
        if eps == 1e-4:
            best = best_seconds(torch, lambda: pkg.solve(qp, st, prepared=prep),
                                reps=3)
            log(f"[{label}] solve {best * 1e3:.2f} ms (best of 3 after a warm "
                "call; no factor)")
        x, status, iters = report_solve(qp, sol, None, None, label)
        del sol
        dev = audit(qp, x, status, iters, label, required=False,
                    prefix="phase 12d", pool=pool)
        if dev <= AUDIT_TARGET:
            break
    require(dev <= AUDIT_TARGET, f"{label}: audit {dev:.3e}")
    del prep
    counts["pivot_sweep_v3"] += setup
    return add_counts(total, counts)


def phase_core(torch, pkg, cnt):
    """Phase 12; returns each sub-phase's launches of CORE_KERNELS."""
    import concurrent.futures
    import multiprocessing

    t0 = time.perf_counter()
    paths = {}
    # The audits' f64 solves run in worker processes (spawned: they import
    # only numpy, scipy and f64_oracle; none touches the card), shut down on
    # the way out, also when a phase fails.
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        for tag, fn in (("12a", phase_core_classes),
                        ("12b", phase_core_anderson),
                        ("12c", phase_core_polish),
                        ("12d", phase_core_reuse)):
            t1 = time.perf_counter()
            paths[tag] = fn(torch, pkg, cnt, pool)
            torch.cuda.empty_cache()
            log(f"[phase {tag}] launches {paths[tag]}; "
                f"{time.perf_counter() - t1:.1f} s")
    log(f"[phase 12] {time.perf_counter() - t0:.1f} s")
    return paths


# --- Phase 13: the rest of the KKT layer and the matrix-free prox path ------

#: 13a: benchmarks/compare_kkt_backends.py's size sweep (:101-131): RANDOM_QP
#: at B=64, m = n/2, seed 1234, every backend at its settings; the audit
#: tightens eps while it misses AUDIT_TARGET (the phase-4 ladder).
KKT_B, KKT_SIZES, KKT_SEED = 64, (64, 128, 256), 1234
KKT_SETTINGS = dict(max_iterations=4000, eps_abs=1e-5, eps_rel=1e-5,
                    rho=0.1, adaptive_rho=True)
KKT_EPS = (1e-5, 2e-6, 1e-6)
KKT_BACKENDS = ("CHOLESKY", "KKT_LDL", "CG", "KKT_MINRES")
#: The host-bound Krylov backends run at the sweep's largest n alone, each
#: timed by its counted run: at every n and best of 3 they took 13a to
#: 104.8 s on the H100 (MINRES 5.7-9.3 s a solve, CG 2.2-2.4 s).
KKT_KRYLOV = ("CG", "KKT_MINRES")
KKT_KRYLOV_SIZES = (KKT_SIZES[-1],)
#: LDL's x against CHOLESKY's on the same fleet at the sweep's eps.
LDL_VS_CHOLESKY = 1e-4
#: Each backend's factor functions (models/kkt.py): (init, refactor).
FACTOR_FNS = {"CHOLESKY": ("cholesky_init", "cholesky_refactor"),
              "KKT_LDL": ("kkt_ldl_init", "kkt_ldl_refactor"),
              "CG": ("cg_init", "cg_refactor"),
              "KKT_MINRES": ("kkt_minres_init", "kkt_minres_refactor")}
#: 13b: compare_kkt_backends.py's crossover (:133-185): the ill-conditioned
#: families at n=256 (HUBER's m capped at 60), CG against MINRES with
#: cg_max_iterations 500, each family at its B (family, m cap, B), every
#: cell timed by its counted run, its ms an outer iteration beside it. Cut
#: to B=4 and CROSSOVER_ITERATIONS outer iterations (both backends of a
#: family alike), and random_qp left to 13a's n=256 cells: at B=16 and 4000
#: iterations with random_qp at B=64 13b took 142.3 s on the H100 (MINRES
#: 52.4 s portfolio, 62.0 s huber, host-bound at ~1 ms a step).
CROSSOVER = (("PORTFOLIO", 0, 4), ("HUBER", 60, 4))
CROSSOVER_ITERATIONS = 100
#: 13c: a tall dense fleet (INEQUALITY_QP, m = 10 n) from the 9-class
#: generator, polished by MINRES; config 4 with the polish on.
TALL_N, TALL_B = 64, 256
POLISH_SETTINGS = dict(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4,
                       rho=0.1, polish_iterations=3)
#: 13e: benchmarks/large_smoothing.py --tpu's problem and settings (:59-87)
#: as one solve at anderson_memory 8 (the benchmark runs 0 and 8; memory 0
#: too took 13e past 90 s, and gave memory 8's iterates: no mix accepted in
#: 8 checks); the f64 n=2000 case of tests/test_operators.py:107-136 (CSR
#: storage: row 13 takes float32), its CPU reference solved meanwhile in a
#: worker process.
SMOOTH_N, SMOOTH_SMALL_N = 50_000, 2000
SMOOTH_SETTINGS = dict(max_iterations=400, eps_abs=1e-5, eps_rel=1e-5,
                       cg_eps=1e-10, cg_max_iterations=300, cg_rel_eps=1e-4)
SMOOTH_SMALL_SETTINGS = dict(max_iterations=2000, eps_abs=1e-6, eps_rel=1e-6,
                             cg_eps=1e-10, cg_max_iterations=300,
                             anderson_memory=8)
SMOOTH_MEMORIES = (8,)
#: f64 residuals recomputed on the host against the reported ones.
RESIDUAL_AGREEMENT = 0.10
#: The kernels phase 13's runs may launch (its paths line).
KKT_KERNELS = ("pivot_sweep_v3", "ell_matvec")


def krylov_counts():
    """The Krylov loops' step and sync counters and the check loop's syncs
    (models/kkt.py: _pcg, _minres; models/admm.py: _solve_core)."""
    from quadraticprogramsolver_tpu_torch.models import admm, kkt

    return {"cg_steps": kkt._pcg.steps, "cg_syncs": kkt._pcg.syncs,
            "minres_steps": kkt._minres.steps,
            "minres_syncs": kkt._minres.syncs,
            "check_syncs": admm._solve_core.syncs}


def since(before):
    now = krylov_counts()
    return {k: now[k] - before[k] for k in now}


def kkt_counts(cnt, label):
    """``read`` of one phase-13 run (no witness wrapper launched); returns
    the KKT_KERNELS counts."""
    read(cnt, (), label)
    return {k: cnt[k].launches for k in KKT_KERNELS}


def kkt_solve(torch, pkg, cnt, qp, st, label, **kw):
    """One counted solve: the factor functions' calls, the kernel launches
    and the Krylov counters of this run alone. Returns (solution, launches,
    factor calls (init, refactor), Krylov counts, seconds)."""
    from quadraticprogramsolver_tpu_torch.models import kkt

    name = kkt.resolve_backend(st.kkt_backend, qp).name
    calls = [CallCount(kkt, f) for f in FACTOR_FNS[name]]
    k0 = krylov_counts()
    try:
        reset(cnt)
        t0 = time.perf_counter()
        sol = pkg.solve(qp, st, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        for c in calls:
            c.close()
    return (sol, kkt_counts(cnt, label), tuple(c.calls for c in calls),
            since(k0), dt)


def krylov_line(k):
    return (f"CG steps {k['cg_steps']} (syncs {k['cg_syncs']}), MINRES "
            f"steps {k['minres_steps']} (syncs {k['minres_syncs']}), check "
            f"syncs {k['check_syncs']}")


def phase_kkt_sweep(torch, pkg, cnt, pool):
    """13a: the four backends over compare_kkt_backends.py's size sweep."""
    import dataclasses

    import numpy as np

    from quadraticprogramsolver_tpu_torch.models import kkt

    total, rows = {}, []
    for n in KKT_SIZES:
        qp = pkg.generate_batch(pkg.ProblemClass.RANDOM_QP, KKT_B, n,
                                seed=KKT_SEED, dtype=np.float32, device=DEVICE)
        first_x = {}
        rho = torch.full((KKT_B,), KKT_SETTINGS["rho"], device=DEVICE)
        for name in KKT_BACKENDS:
            if name in KKT_KRYLOV and n not in KKT_KRYLOV_SIZES:
                continue
            base = pkg.Settings(kkt_backend=pkg.KKTBackendKind[name],
                                **KKT_SETTINGS)
            for eps in KKT_EPS:
                st = dataclasses.replace(base, eps_abs=eps, eps_rel=eps)
                label = f"phase 13a {name.lower()} n={n} eps {eps:.0e}"
                sol, launches, (inits, refactors), k, dt = kkt_solve(
                    torch, pkg, cnt, qp, st, label)
                add_counts(total, launches)
                status, iters, solved, line = stats_line(sol)
                require(solved == KKT_B, f"{label}: {KKT_B - solved} lanes "
                        "did not end with status 2 or 3")
                piv = launches["pivot_sweep_v3"]
                want = {"CHOLESKY": n // 128 * inits, "KKT_LDL": 0, "CG": 0,
                        "KKT_MINRES": n // 128}[name]
                require(piv == want, f"{label}: {piv} row-2 launches, not "
                        f"{want}")
                row = {"backend": name, "n": n, "m": qp.m, "eps": eps,
                       "solved": solved,
                       "p50_iterations": float(np.median(iters)),
                       "factor_builds": inits, "refactor_calls": refactors,
                       "row2_launches": piv, **k}
                timed = ""
                if eps == KKT_EPS[0]:
                    first_x[name] = sol.x
                    if name in KKT_KRYLOV:
                        best, how = dt, "its counted run alone"
                    else:
                        best = min(dt, best_seconds(
                            torch, lambda: pkg.solve(qp, st), 2))
                        how = "best of 3, the counted run one"
                    sigma = st.sigma_for(torch.float32)
                    init = getattr(kkt, FACTOR_FNS[name][0])
                    fdt = best_seconds(
                        torch, lambda: init(qp, rho, sigma, st), 3)
                    row.update(ms=best * 1e3, factor_ms=fdt * 1e3)
                    timed = (f"; solve {best * 1e3:.2f} ms ({how}), "
                             f"factor {fdt * 1e3:.3f} ms "
                             f"({FACTOR_FNS[name][0]} alone, best of 3)")
                log(f"[{label}] {line}; factor builds {inits}, refactor "
                    f"calls {refactors}; row-2 launches {piv}; "
                    f"{krylov_line(k)}{timed}")
                dev, _ = audit_lanes(qp, sol.x.double().cpu().numpy(),
                                     status, iters, label, required=False,
                                     pool=pool)
                row["audit"] = dev
                rows.append(row)
                del sol
                if dev <= AUDIT_TARGET:
                    break
            require(dev <= AUDIT_TARGET, f"{label}: audit {dev:.3e}")
        gap = float((first_x["KKT_LDL"] - first_x["CHOLESKY"]).abs().max())
        log(f"[phase 13a n={n}] max|x_ldl - x_cholesky| {gap:.3e} (limit "
            f"{LDL_VS_CHOLESKY:.0e})")
        require(gap <= LDL_VS_CHOLESKY, f"phase 13a n={n}: LDL's x "
                f"{gap:.3e} from CHOLESKY's")
        del qp, first_x
        torch.cuda.empty_cache()
    log("[phase 13a] table: " + json.dumps(rows))
    return total


def phase_kkt_crossover(torch, pkg, cnt):
    """13b: CG against MINRES on the ill-conditioned families."""
    import numpy as np

    total, rows = {}, []
    n = KKT_SIZES[-1]
    for family, cap, b in CROSSOVER:
        qp = pkg.generate_batch(pkg.ProblemClass[family], b, n, cap,
                                seed=KKT_SEED, dtype=np.float32, device=DEVICE)
        for name in KKT_KRYLOV:
            st = pkg.Settings(kkt_backend=pkg.KKTBackendKind[name],
                              cg_max_iterations=500, **dict(
                                  KKT_SETTINGS,
                                  max_iterations=CROSSOVER_ITERATIONS))
            label = f"phase 13b {family.lower()} {name.lower()}"
            sol, launches, _, k, dt = kkt_solve(torch, pkg, cnt, qp, st,
                                                label)
            add_counts(total, launches)
            _, iters, solved, line = stats_line(sol)
            del sol
            steps = k["cg_steps"] + k["minres_steps"]
            outer = int(iters.max())
            log(f"[{label}] (n={qp.n}, m={qp.m}, B={b}, at most "
                f"{CROSSOVER_ITERATIONS} iterations) {line}; "
                f"{krylov_line(k)}; solve {dt * 1e3:.2f} ms (its counted "
                f"run alone), {dt * 1e3 / outer:.3f} ms an outer iteration, "
                f"{steps / outer:.1f} Krylov steps an outer iteration")
            rows.append({"family": family, "backend": name, "n": qp.n,
                         "m": qp.m, "B": b, "ms": dt * 1e3, "solved": solved,
                         "p50_iterations": float(np.median(iters)),
                         "outer_iterations": outer,
                         "ms_per_outer_iteration": dt * 1e3 / outer,
                         "krylov_steps": steps, **k})
        del qp
        torch.cuda.empty_cache()
    log("[phase 13b] table: " + json.dumps(rows))
    return total


class PolishWatch:
    """Wraps models/admm.py's polish_fn: keeps the ADMM (x, y), the polished
    ones and the ELL launches inside the polish, until close()."""

    def __init__(self, admm, spmv):
        self.admm, self.spmv, self.orig = admm, spmv, admm.polish_fn
        self.seen = {}

        def watched(qp, settings, x, z, y, rho):
            before = spmv.ell_matvec.launches
            out = self.orig(qp, settings, x, z, y, rho)
            self.seen.update(qp=qp, x=x, y=y, out=out,
                             ell=spmv.ell_matvec.launches - before)
            return out

        admm.polish_fn = watched

    def close(self):
        self.admm.polish_fn = self.orig

    def report(self, label):
        """(share of lanes accepted, KKT errors before, after) as numpy."""
        from quadraticprogramsolver_tpu_torch.models import polish

        qp, x, y = self.seen["qp"], self.seen["x"], self.seen["y"]
        x_out, y_out = self.seen["out"]
        accepted = (x_out != x).reshape(-1, x.shape[-1]).any(-1)
        err0 = polish._kkt_error(qp, x, y).reshape(-1).cpu().numpy()
        err1 = polish._kkt_error(qp, x_out, y_out).reshape(-1).cpu().numpy()
        require(bool((err1 <= err0).all()), f"{label}: a lane's KKT error "
                "grew")
        return float(accepted.float().mean()), err0, err1


def phase_kkt_polish(torch, pkg, cnt, pool, config4):
    """13c: the MINRES polish on a tall dense fleet and on config 4."""
    import numpy as np

    from quadraticprogramsolver_tpu_torch.models import admm
    from quadraticprogramsolver_tpu_torch.ops import spmv

    total = {}
    qp = pkg.generate_batch(pkg.ProblemClass.INEQUALITY_QP, TALL_B, TALL_N,
                            seed=KKT_SEED, dtype=np.float32, device=DEVICE)
    require(qp.m > qp.n, f"phase 13c: the tall fleet has m={qp.m} <= n={qp.n}")
    st = pkg.Settings(**POLISH_SETTINGS)
    label = f"phase 13c tall fleet (n={qp.n}, m={qp.m}, B={TALL_B})"
    watch = PolishWatch(admm, spmv)
    try:
        sol, launches, _, k, dt = kkt_solve(torch, pkg, cnt, qp, st, label)
    finally:
        watch.close()
    add_counts(total, launches)
    share, err0, err1 = watch.report(label)
    status, iters, solved, line = stats_line(sol)
    log(f"[{label}] {line}; polish by MINRES: lanes accepted {share:.3f}, "
        f"KKT error p50 {np.median(err0):.3e} before, {np.median(err1):.3e} "
        f"after; {krylov_line(k)}; solve {dt * 1e3:.2f} ms (counted run)")
    require(share >= 0.5, f"{label}: the polish was accepted on {share:.3f} "
            "of the lanes")
    # Reported: eps 1e-4 in f32 does not fix this family's x to the
    # target, polished or not.
    audit_lanes(qp, sol.x.double().cpu().numpy(), status, iters, label,
                required=False, pool=pool)
    del sol, qp, watch

    data, scal, ell, _ = config4
    st = pkg.Settings(polish_iterations=3, **SPARSE_SETTINGS)
    label = "phase 13c config 4 with polish"
    watch = PolishWatch(admm, spmv)
    try:
        sol, launches, _, k, dt = kkt_solve(torch, pkg, cnt, ell, st, label,
                                            scaling=scal)
    finally:
        watch.close()
    add_counts(total, launches)
    share, err0, err1 = watch.report(label)
    osqp_f64(data, sol, label)
    log(f"[{label}] status {int(sol.info.status)}, outer iterations "
        f"{int(sol.info.iterations)}; polish {'accepted' if share else 'rejected'}"
        f", KKT error (scaled problem) {err0[0]:.3e} before, {err1[0]:.3e} "
        f"after; ELL launches {launches['ell_matvec']} "
        f"({watch.seen['ell']} in the polish); {krylov_line(k)}; solve "
        f"{dt * 1e3:.2f} ms (counted run)")
    # The polish moves x and y, not z, so the f64 criterion (|Ax - z| among
    # its terms) is reported, not required, here.
    require(watch.seen["ell"] > 0, f"{label}: the polish launched no ELL "
            "kernel")
    require(int(sol.info.status) == 3, f"{label}: status "
            f"{int(sol.info.status)}, not SOLVED")
    return total


def phase_kkt_sparse(torch, pkg, cnt, config4):
    """13d: KKT_MINRES (the Jacobi preconditioner) on config 4, CG's solve
    beside it."""
    total, out = {}, {}
    data, scal, ell, _ = config4
    for name in ("KKT_MINRES", "CG"):
        st = pkg.Settings(kkt_backend=pkg.KKTBackendKind[name],
                          **SPARSE_SETTINGS)
        label = f"phase 13d config 4 {name.lower()}"
        sol, launches, _, k, dt = kkt_solve(torch, pkg, cnt, ell, st, label,
                                            scaling=scal)
        add_counts(total, launches)
        status, iters = int(sol.info.status), int(sol.info.iterations)
        ok, _ = osqp_f64(data, sol, label)
        del sol
        best = min(dt, best_seconds(
            torch, lambda: pkg.solve(ell, st, scaling=scal), 2))
        log(f"[{label}] status {status}, outer iterations {iters}; ELL "
            f"launches {launches['ell_matvec']}; {krylov_line(k)}; solve "
            f"{best * 1e3:.2f} ms (best of 3), {best * 1e3 / max(iters, 1):.3f}"
            f" ms per outer iteration")
        require(launches["ell_matvec"] > 0, f"{label}: no ELL launch")
        require(status == 3 and ok, f"{label}: status {status}, f64 "
                f"criterion {'pass' if ok else 'FAIL'}")
        out[name] = best
    log(f"[phase 13d] KKT_MINRES {out['KKT_MINRES'] * 1e3:.2f} ms against CG "
        f"{out['CG'] * 1e3:.2f} ms ({out['KKT_MINRES'] / out['CG']:.2f}x)")
    return total


def smoothing_problem(pkg, n, dtype, storage, device=None):
    """large_smoothing.py's signal and QP (seed 0, lam 50, x[0] pinned), on
    ``device`` (the card by default)."""
    import numpy as np
    import scipy.sparse as sp

    from quadraticprogramsolver_tpu_torch.problems.operators import (
        monotone_smoothing_sparse_qp)

    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, n)
    y = np.sin(np.pi * t) + 0.05 * rng.standard_normal(n)
    P, q, C, d = monotone_smoothing_sparse_qp(y, np.array([0, n // 2, n - 1]),
                                              smooth_order=2, lam=50.0)
    A = sp.csr_matrix(([1.0], ([0], [0])), shape=(1, n))
    args = (P, q, A, np.array([y[0]]), C, d)
    return y, args, pkg.make_sparse_proxqp(*args, dtype=dtype,
                                           storage=storage,
                                           device=device or DEVICE)


def _cpu_smoothing_solve(n):
    """The port's float64 solve of the n-sample smoothing problem on the
    CPU (a worker process's job): (status, iterations, x, seconds)."""
    import numpy as np

    import quadraticprogramsolver_tpu_torch as pkg

    _, _, prob = smoothing_problem(pkg, n, np.float64, "ell", device="cpu")
    t0 = time.perf_counter()
    sol = pkg.solve_proxqp(prob, pkg.ProxQPSettings(**SMOOTH_SMALL_SETTINGS))
    return (int(sol.info.status), int(sol.info.iterations), sol.x.numpy(),
            time.perf_counter() - t0)


#: large_smoothing.py's exact piecewise-monotone check (:99-101): no step
#: against a segment's direction larger than this.
MONOTONE_TOL = 1e-6


def monotone_violation(x):
    """The largest step of x against its segment's direction (rising on the
    first half, falling on the second): large_smoothing.py's check passes
    when it is at most MONOTONE_TOL."""
    import numpy as np

    half = x.size // 2
    return float(max(-np.diff(x[: half + 1]).min(), np.diff(x[half:]).max()))


def host_residuals(args, sol):
    """The PIQP residuals of (x, s, y, z) recomputed in f64 with scipy."""
    import numpy as np

    P, q, A, b, C, d = args
    x, s, y, z = (t.double().cpu().numpy() for t in (sol.x, sol.s, sol.y,
                                                       sol.z))
    res_prim = max(np.abs(A @ x - b).max(), np.abs(C @ x - d + s).max())
    res_dual = np.abs(P @ x + A.T @ y + C.T @ z + q).max()
    return float(res_prim), float(res_dual)


def phase_kkt_smoothing(torch, pkg, cnt, pool):
    """13e: the smoothing application at n = 5e4 (f32, ELL), then the
    n = 2000 case in f64 on the card against the port's CPU f64 solve (in
    one of ``pool``'s processes, while the card works)."""
    import numpy as np

    from quadraticprogramsolver_tpu_torch.models import anderson, kkt

    total = {}
    cpu_job = pool.submit(_cpu_smoothing_solve, SMOOTH_SMALL_N)
    y, args, prob = smoothing_problem(pkg, SMOOTH_N, np.float32, "ell")
    log(f"[phase 13e] n={SMOOTH_N}: P nnz {args[0].nnz}, C rows "
        f"{args[4].shape[0]}; ELL widths P {prob.P_vals.shape[1]}, C "
        f"{prob.C_vals.shape[1]}, C' {prob.Ct_vals.shape[1]}")
    for mem in SMOOTH_MEMORIES:
        st = pkg.ProxQPSettings(anderson_memory=mem, **SMOOTH_SETTINGS)
        label = f"phase 13e n={SMOOTH_N} anderson_memory={mem}"
        k0 = krylov_counts()
        acc = AcceptCount(torch, anderson, "aa_step_proxqp", prox=True)
        try:
            reset(cnt)
            t0 = time.perf_counter()
            sol = pkg.solve_proxqp(prob, st)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            acc.close()
        share, offered = acc.share()
        launches = kkt_counts(cnt, label)
        add_counts(total, launches)
        k = since(k0)
        x = sol.x.double().cpu().numpy()
        rp, rd = float(sol.info.res_prim), float(sol.info.res_dual)
        hp, hd = host_residuals(args, sol)
        iters = int(sol.info.iterations)
        viol = monotone_violation(x)
        log(f"[{label}] status {int(sol.info.status)}, iterations {iters}, "
            f"res_prim {rp:.3e} res_dual {rd:.3e} (f64 on the host: {hp:.3e}"
            f", {hd:.3e}); {dt:.2f} s ({dt / max(iters, 1) * 1e3:.2f} ms an "
            f"outer iteration); CG steps {k['cg_steps']} ({k['cg_syncs']} "
            f"syncs); ELL launches {launches['ell_matvec']}; Anderson mixes "
            f"accepted {share:.3f} of {offered}; largest step "
            f"against the monotone direction {viol:.3e} (the exact check, "
            f"{MONOTONE_TOL:.0e}: {'pass' if viol <= MONOTONE_TOL else 'miss'})"
            f", |x[0] - y[0]| {abs(x[0] - y[0]):.3e}")
        # The exact check asks more than 400 f32 iterations reach: the
        # benchmark documents res_prim 8e-6 there (large_smoothing.py:17-20)
        # and a step against the monotone direction is a primal residual
        # of C x <= 0. So the signal is held monotone within the solve's
        # primal residual, recomputed in f64.
        require(viol <= max(MONOTONE_TOL, hp), f"{label}: a step of "
                f"{viol:.3e} against the monotone direction, beyond the "
                f"primal residual {hp:.3e}")
        require(abs(x[0] - y[0]) <= 1e-5, f"{label}: x[0] is "
                f"{abs(x[0] - y[0]):.3e} from y[0]")
        require(abs(hp - rp) <= RESIDUAL_AGREEMENT * hp
                and abs(hd - rd) <= RESIDUAL_AGREEMENT * hd,
                f"{label}: the reported residuals ({rp:.3e}, {rd:.3e}) are "
                f"not within {RESIDUAL_AGREEMENT:.0%} of f64's ({hp:.3e}, "
                f"{hd:.3e})")
        require(launches["ell_matvec"] > 0, f"{label}: no ELL launch")
        del sol
    del prob

    # tests/test_operators.py's n = 2000 case in float64 on the card (CSR:
    # the ELL kernel takes float32) against the same solve on the CPU.
    st = pkg.ProxQPSettings(**SMOOTH_SMALL_SETTINGS)
    label = f"phase 13e n={SMOOTH_SMALL_N} f64"
    y, args, prob = smoothing_problem(pkg, SMOOTH_SMALL_N, np.float64, "bcoo")
    k0 = krylov_counts()
    t0 = time.perf_counter()
    sol = pkg.solve_proxqp(prob, st)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k = since(k0)
    ref_status, ref_iters, ref_x, cpu_s = cpu_job.result()
    x = sol.x.cpu().numpy()
    dev = float(np.abs(x - ref_x).max())
    viol = monotone_violation(x)
    log(f"[{label}] card: status {int(sol.info.status)}, iterations "
        f"{int(sol.info.iterations)}, {dt:.2f} s, CG steps {k['cg_steps']}; "
        f"CPU: status {ref_status}, iterations {ref_iters}, {cpu_s:.2f} s "
        f"(a worker process); max|x_card - x_cpu| "
        f"{dev:.3e}; largest step against the monotone direction {viol:.3e}")
    require(int(sol.info.status) == 3 and viol <= MONOTONE_TOL,
            f"{label}: status {int(sol.info.status)}, a step of {viol:.3e} "
            "against the monotone direction")
    require(dev <= 1e-6, f"{label}: x {dev:.3e} from the CPU solve")
    require(kkt._pcg.steps > k0["cg_steps"], f"{label}: no CG step")
    return total


def phase_kkt(torch, pkg, cnt, config4=None):
    """Phase 13; returns each sub-phase's launches of KKT_KERNELS."""
    import concurrent.futures
    import multiprocessing

    t0 = time.perf_counter()
    paths = {}
    if config4 is None:
        config4 = sparse_problem(pkg)
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        steps = (("13a", lambda: phase_kkt_sweep(torch, pkg, cnt, pool)),
                 ("13b", lambda: phase_kkt_crossover(torch, pkg, cnt)),
                 ("13c", lambda: phase_kkt_polish(torch, pkg, cnt, pool,
                                                  config4)),
                 ("13d", lambda: phase_kkt_sparse(torch, pkg, cnt, config4)),
                 ("13e", lambda: phase_kkt_smoothing(torch, pkg, cnt, pool)))
        for tag, fn in steps:
            t1 = time.perf_counter()
            paths[tag] = fn()
            torch.cuda.empty_cache()
            log(f"[phase {tag}] launches {paths[tag]}; "
                f"{time.perf_counter() - t1:.1f} s")
    require(paths["13a"]["pivot_sweep_v3"] > 0,
            "phase 13: MINRES's dense preconditioner never launched row 2")
    require(all(paths[t]["ell_matvec"] > 0 for t in ("13c", "13d", "13e")),
            "phase 13: a sparse path never launched row 13")
    log(f"[phase 13] {time.perf_counter() - t0:.1f} s")
    return paths


# --- Phase 14: reduced product precision and the host utilities -------------

#: 14a: benchmarks/factor_precision.py:49-66: bench.py's random_qp fleet
#: (n=512, m=256, seed 1234) at B=2048, rho 0.3 adaptive, check interval 25,
#: eps 1e-4 (tightened while the audit misses the target), the fused M^{-1}
#: chunk; its three configurations and "high" with one refinement step.
PREC_SETTINGS = dict(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4, rho=0.3,
                     adaptive_rho=True, check_interval=25,
                     kkt_refinement_steps=0, fused_chunk=True,
                     require_fused=True)
FACTOR_CONFIGS = {"highest refine 0": {},
                  "default refine 1": dict(factor_precision="default",
                                           kkt_refinement_steps=1),
                  "default refine 2": dict(factor_precision="default",
                                           kkt_refinement_steps=2),
                  "high refine 1": dict(factor_precision="high",
                                        kkt_refinement_steps=1)}
#: The configurations that one bf16 pass leaves without a converging
#: solve on this fleet, run once and reported: ||I - M~^{-1} M||_2 ~ 0.09
#: at rho 0.3 (a CPU measurement at B=4), so one refinement step leaves a
#: residual floor near 1e-2 relative; the adaptive rule then drives rho
#: towards RHO_MIN, where the approximate inverse stops contracting
#: (||E|| > 1) and the iterates diverge (a CPU rehearsal at B=8: every lane
#: non-finite at 2000 iterations; at a static rho 0.3 every lane stalls).
UNGATED_FACTOR = ("default refine 1",)
#: tests/test_fused_admm.py:93's limit on x against the "highest" solve,
#: printed beside each reduced factor's (JAX's CPU run ignores the knob).
FACTOR_X_LIMIT = 1e-5
AUDIT_EPS = (1e-4, 2e-5, 1e-5)
#: 14b: matmul_precision on phase 7a's fleet and settings (bench.py's
#: defaults row: default Settings, eps 1e-4, the torch chunk). "default"
#: floors the residuals near 1e-2 (the stall the JAX package documents,
#: models/admm.py:664-668; tests/test_torch_precision.py): it runs once at
#: 1e-4, where every x must stay finite, then at DEFAULT_EPS, where at least
#: DEFAULT_SHARE of the lanes must converge and the audit of the converged
#: ones stay within DEFAULT_X (the CPU test's bound). On the H100, 20 of
#: 2048 lanes stalled there.
DEFAULT_EPS, DEFAULT_SHARE, DEFAULT_X = 3e-2, 0.95, 5e-2
#: "default"'s ungated run at eps 1e-4 (its stall: no lane converges, every
#: x finite) stops at this many iterations; at 2000, as the gated run at
#: DEFAULT_EPS keeps (at 500 that run converged 1937/2048 lanes, under
#: DEFAULT_SHARE), it took ~15 s of 14b's 56.7 on the H100. "high" is
#: timed by its counted run (4.5 s a solve).
DEFAULT_STALL_ITERATIONS = 500
#: 14c: the card's bf16 products against an f64 recomputation from the same
#: bf16-rounded operands, relative to the max (only the FP32 accumulation
#: differs).
BF16_PRODUCT_LIMIT = 1e-6
#: 14e: the port's f64 reference (native LDL') against f64_oracle.py's
#: (splu) on the same lanes.
ORACLE_AGREEMENT = 1e-8
#: 14e: the problem lanes of the checkpoint round trip.
CKPT_LANES = 64
#: The kernels phase 14's runs may launch (its paths line).
PREC_KERNELS = ("pivot_sweep_v3", "admm_chunk_minv", "admm_chunk_minv_cluster")


def precision_fleet(torch, pkg):
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    qp = device_random_qp_fleet(B_DEFAULTS, N, M, generator=g)
    torch.cuda.synchronize()
    return qp


def max_dev(a, b):
    return float((a.double() - b.double()).abs().max())


def laddered_solve(torch, pkg, cnt, qp, settings, path, label, pool,
                   eps_ladder=AUDIT_EPS, required=True):
    """A counted solve (every launch counter at 0 before it; rows 2 a factor
    build, no Cholesky: ``counted_solve``) at each eps of the ladder while
    the audit of 8 spread and 8 straggling lanes misses the target; with
    ``required`` every lane must end with status 2 or 3 and the last audit
    pass. Returns (settings, solution, launches, builds, audit, the last
    counted solve's seconds)."""
    import dataclasses

    from quadraticprogramsolver_tpu_torch.models import kkt

    for eps in eps_ladder:
        st = dataclasses.replace(settings, eps_abs=eps, eps_rel=eps)
        lbl = f"{label} eps {eps:.0e}"
        t0 = time.perf_counter()
        sol, counts, builds = counted_solve(
            torch, cnt, lambda: pkg.solve(qp, st), kkt, "cholesky_init", path,
            lbl)
        sec = time.perf_counter() - t0
        if "admm_chunk_minv" in path:
            counts.update(minv_cluster_only(cnt, "admm_chunk_minv", lbl))
        status = sol.info.status.cpu().numpy()
        if not required and not ((status == 2) | (status == 3)).all():
            return st, sol, counts, builds, None, sec
        x, status, iters = report_solve(qp, sol, None, None, f"{lbl} counted")
        dev = audit(qp, x, status, iters, lbl, required=False,
                    prefix="phase 14", pool=pool)
        if dev <= AUDIT_TARGET:
            break
    require(not required or dev <= AUDIT_TARGET,
            f"{label}: audit {dev:.3e} > {AUDIT_TARGET:.0e} at eps "
            f"{eps_ladder[-1]:.0e}")
    return st, sol, counts, builds, dev, sec


def phase_precision_factor(torch, pkg, cnt, pool, qp):
    """14a: factor_precision on the M^{-1} route."""
    import numpy as np

    from quadraticprogramsolver_tpu_torch.models import kkt

    paths, x_highest = {}, None
    for name, kw in FACTOR_CONFIGS.items():
        label = f"phase 14a {name}"
        settings = pkg.Settings(**{**PREC_SETTINGS, **kw})
        p = pkg.plan(qp, settings)
        require((p.factor, p.chunk, p.cache)
                == ("sweep_inverse", "fused_kernel", "M_inv"),
                f"{label}: unexpected plan {p}")
        if name in UNGATED_FACTOR:
            t0 = time.perf_counter()
            sol, counts, builds = counted_solve(
                torch, cnt, lambda: pkg.solve(qp, settings), kkt,
                "cholesky_init", ADMM_MINV_PATH, label)
            dt = time.perf_counter() - t0
            counts.update(minv_cluster_only(cnt, "admm_chunk_minv", label))
            paths[name] = counts
            status = sol.info.status.cpu().numpy()
            iters = sol.info.iterations.cpu().numpy()
            finite = int(sol.x.isfinite().all(-1).sum())
            rho = sol.info.rho
            log(f"[{label}] eps 1e-4, one run: {dt * 1e3:.2f} ms, statuses "
                f"{ {int(k): int(v) for k, v in zip(*np.unique(status, return_counts=True))} }, "
                f"iterations p50 {np.median(iters):.0f} max {iters.max()}, "
                f"lanes with a finite x {finite}/{status.size}, final rho "
                f"{float(rho.min()):.3g}-{float(rho.max()):.3g}, pivot "
                f"launches {counts['pivot_sweep_v3']} for {builds} builds "
                f"(reported, not gated: one refinement step does not carry "
                f"a one-pass bf16 M^-1 here)")
            del sol
            continue
        st, sol, counts, builds, dev, _ = laddered_solve(
            torch, pkg, cnt, qp, settings, ADMM_MINV_PATH, label, pool)
        paths[name] = counts
        iters = sol.info.iterations.cpu().numpy()
        if x_highest is None:
            x_highest = sol.x
            vs = "(the reference)"
        else:
            d = max_dev(sol.x, x_highest)
            vs = (f"max |x - x_highest| {d:.3e} (tests/test_fused_admm.py's "
                  f"limit {FACTOR_X_LIMIT:.0e}: "
                  f"{'within' if d <= FACTOR_X_LIMIT else 'beyond'})")
        del sol
        _, dt = run_main(torch, lambda: pkg.solve(qp, st))
        fdt = factor_seconds(torch, qp, st)
        log(f"[{label}] eps {st.eps_abs:.0e}: solve {dt * 1e3:.2f} ms (best of "
            f"3), factor {fdt * 1e3:.2f} ms alone (best of 4), iterations p50 "
            f"{np.median(iters):.0f} max {iters.max()}, audit {dev:.3e}, "
            f"pivot launches {counts['pivot_sweep_v3']} for {builds} builds; "
            f"{vs}")
    return paths


def phase_precision_matmul(torch, pkg, cnt, pool, qp):
    """14b: matmul_precision "high" and "default" on phase 7a's fleet beside
    "highest"."""
    import dataclasses

    import numpy as np

    paths = {}
    base = pkg.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4)
    for prec in ("highest", "high", "default"):
        label = f"phase 14b {prec}"
        settings = dataclasses.replace(base, matmul_precision=prec)
        if prec == "default":
            for eps, cap in ((1e-4, DEFAULT_STALL_ITERATIONS),
                             (DEFAULT_EPS, settings.max_iterations)):
                # Its stragglers run to max_iterations: the counted run is
                # its one timed run.
                st, sol, counts, _, dev, dt = laddered_solve(
                    torch, pkg, cnt, qp,
                    dataclasses.replace(settings, max_iterations=cap),
                    ADMM_DEFAULTS_PATH, label, pool, eps_ladder=(eps,),
                    required=False)
                status = sol.info.status.cpu().numpy()
                iters = sol.info.iterations.cpu().numpy()
                solved = int(((status == 2) | (status == 3)).sum())
                if dev is None and solved:
                    dev = audit(qp, sol.x.double().cpu().numpy(), status, iters,
                                f"{label} eps {eps:.0e}", required=False,
                                prefix="phase 14", pool=pool)
                log(f"[{label}] eps {eps:.0e}: statuses "
                    f"{ {int(k): int(v) for k, v in zip(*np.unique(status, return_counts=True))} }, "
                    f"solved {solved}/{status.size}, iterations p50 "
                    f"{np.median(iters):.0f} max {iters.max()}, lanes with a "
                    f"finite x {int(sol.x.isfinite().all(-1).sum())}, audit of "
                    f"the converged lanes {dev}")
                require(bool(sol.x.isfinite().all()),
                        f"{label} eps {eps:.0e}: a non-finite x")
                if eps != DEFAULT_EPS:
                    del sol
            require(solved >= DEFAULT_SHARE * status.size
                    and dev is not None and dev <= DEFAULT_X,
                    f"{label}: {solved}/{status.size} lanes converged at eps "
                    f"{DEFAULT_EPS:.0e} (at least {DEFAULT_SHARE:.0%} needed), "
                    f"audit {dev} (limit {DEFAULT_X:.0e})")
            runs = "one run"
        else:
            st, sol, counts, _, dev, dt = laddered_solve(
                torch, pkg, cnt, qp, settings, ADMM_DEFAULTS_PATH, label, pool)
            runs = "its counted run"
        iters = sol.info.iterations.cpu().numpy()
        del sol
        if prec == "highest":
            _, dt = run_main(torch, lambda: pkg.solve(qp, st))
            runs = "best of 3"
        paths[prec] = counts
        log(f"[{label}] eps {st.eps_abs:.0e}: solve {dt * 1e3:.2f} ms ({runs}), "
            f"iterations p50 {np.median(iters):.0f} max {iters.max()}, "
            f"audit {dev:.3e}")
    return paths


BF16_GEMM = ("nvjet_t", "bf16")


def bf16_gemms(names):
    """The traced kernels that are cuBLAS bf16 GEMMs (cuBLASLt's nvjet
    kernels name a bf16 A operand "t"; others name bf16)."""
    return {k: v for k, v in names.items()
            if k.startswith(BF16_GEMM[0]) or BF16_GEMM[1] in k.lower()}


def phase_precision_products(torch, pkg, qp):
    """14c: one factor's M at "default" and "high" against an f64
    recomputation from the same bf16-rounded operands, and the factor's
    traced kernels at each precision."""
    from quadraticprogramsolver_tpu_torch.models import kkt
    from quadraticprogramsolver_tpu_torch.ops import linalg

    routed = "aten::mm.dtype" in str(torch._C._jit_get_schemas_for_operator("aten::mm"))
    log(f"[phase 14c] bf16 products on the card: torch.mm/torch.bmm with "
        f"out_dtype=float32 (aten::mm.dtype registered: {routed})")
    require(routed, "phase 14c: this torch has no out_dtype product")
    sigma = 1e-6
    rho_row = torch.full((B_DEFAULTS, M), 0.3, device=DEVICE)
    Aw = qp.A.transpose(-1, -2) * rho_row[..., None, :]
    out = {}
    for prec in ("default", "high"):
        with linalg.products(prec):
            Mn = kkt._build_normal_matrix(qp, rho_row, sigma)
        torch.cuda.synchronize()
        if prec == "default":
            gram = linalg.bf16_round(Aw).double() @ linalg.bf16_round(qp.A).double()
        else:
            (ah, al), (bh, bl) = (tuple(h.double() for h in linalg.bf16_split(t))
                                  for t in (Aw, qp.A))
            gram = ah @ bh + ah @ bl + al @ bh
            del ah, al, bh, bl
        ref = qp.P.double() + gram + sigma * torch.eye(N, device=DEVICE,
                                                       dtype=torch.float64)
        del gram
        rel = max_dev(Mn, ref) / float(ref.abs().max())
        full = max_dev(Mn, qp.P.double() + Aw.double() @ qp.A.double()
                       + sigma * torch.eye(N, device=DEVICE, dtype=torch.float64))
        del ref, Mn
        log(f"[phase 14c] M at {prec} (B={B_DEFAULTS}, n={N}, m={M}): "
            f"{rel:.3e} of max from the f64 product of the bf16-rounded "
            f"operands (limit {BF16_PRODUCT_LIMIT:.0e}); {full:.3e} from "
            f"the exact M")
        require(rel <= BF16_PRODUCT_LIMIT, f"phase 14c: M at {prec} {rel:.3e} "
                f"from its plain version")
        out[prec] = rel
    del Aw
    rho = torch.full((B_DEFAULTS,), 0.3, device=DEVICE)
    for prec in ("highest", "default", "high"):
        st = pkg.Settings(factor_precision=prec)
        traced_k = device_kernels(
            torch, lambda: kkt.cholesky_init(qp, rho, sigma, st))
        gemms = bf16_gemms(traced_k)
        others = sorted(k for k in traced_k if "gemm" in k.lower()
                        or k.startswith("nvjet"))
        log(f"[phase 14c] one factor at {prec}: bf16 GEMM kernels "
            f"{ {k[:60]: v[0] for k, v in gemms.items()} }; every GEMM "
            f"kernel traced: {[k[:60] for k in others]}")
        require(bool(gemms) == (prec != "highest"),
                f"phase 14c: the {prec} factor traced bf16 GEMMs {list(gemms)}")
    return out


def phase_precision_gram_finding(torch):
    """14d, a finding only: one (2048, 256, 512) gram A'A five ways."""
    from quadraticprogramsolver_tpu_torch.ops import linalg

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    A = torch.randn((B_DEFAULTS, M, N), generator=g, device=DEVICE)
    At = A.transpose(1, 2)
    ref = At.double() @ A.double()
    scale = float(ref.abs().max())

    def tf32_split(t):
        hi = (t.view(torch.int32) & ~0x1FFF).view(torch.float32)
        return hi, t - hi

    def with_tf32(fn):
        def run():
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return fn()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        return run

    def tf32x3():
        (ah, al), (bh, bl) = tf32_split(At.contiguous()), tf32_split(A)
        return torch.bmm(ah, bh) + torch.bmm(ah, bl) + torch.bmm(al, bh)

    ways = {"fp32": lambda: torch.bmm(At, A),
            "tf32": with_tf32(lambda: torch.bmm(At, A)),
            "3xtf32": with_tf32(tf32x3),
            "bf16 fp32-out": lambda: linalg.mm(At, A, "default"),
            "bf16x3": lambda: linalg.mm(At, A, "high")}
    out = {}
    for name, fn in ways.items():
        err = max_dev(fn(), ref) / scale
        ms = cuda_ms(fn)
        out[name] = (ms, err)
        log(f"[phase 14d] gram (2048, 256, 512) {name}: {ms:.4f} ms, "
            f"{err:.3e} of max from f64")
    require(not torch.backends.cuda.matmul.allow_tf32, "phase 14d: TF32 left on")
    return out


def phase_precision_utils(torch, pkg, pool):
    """14e: the host utilities on card results."""
    import glob
    import tempfile

    import numpy as np

    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)
    from quadraticprogramsolver_tpu_torch.problems.generator import (
        ProblemClass, generate_random_qp)
    from quadraticprogramsolver_tpu_torch.utils import (
        checkpoint, diagnostics, feasibility, oracle, profiling)

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    qp = device_random_qp_fleet(B_MAIN, N, M, generator=g)
    static = pkg.Settings(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4,
                          rho=0.4, check_interval=11, kkt_refinement_steps=0,
                          sigma_free_rhs=True, fused_factor=True,
                          fused_chunk=True, require_fused=True,
                          adaptive_rho=False)
    sol = pkg.solve(qp, static)
    torch.cuda.synchronize()
    # The whole solution, and the problem's first CKPT_LANES lanes (its
    # (B, n, n) P alone is 4.3 GB at B=4096).
    head = pkg.QP(*(t[:CKPT_LANES] for t in qp.tensors()))
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_qp(os.path.join(tmp, "qp.npz"), head)
        checkpoint.save_solution(os.path.join(tmp, "sol.npz"), sol)
        qp2 = checkpoint.load_qp(os.path.join(tmp, "qp.npz"))
        sol2 = checkpoint.load_solution(os.path.join(tmp, "sol.npz"))
        same = (all(a.is_cuda and torch.equal(a, b)
                    for a, b in zip(qp2.tensors(), head.tensors()))
                and all(getattr(sol2, k).is_cuda
                        and torch.equal(getattr(sol2, k), getattr(sol, k))
                        for k in ("x", "z", "y"))
                and all(torch.equal(getattr(sol2.info, k), getattr(sol.info, k))
                        for k in ("status", "iterations", "res_prim",
                                  "res_dual", "rho", "objective")))
        size = sum(os.path.getsize(f) for f in glob.glob(f"{tmp}/*.npz"))
    log(f"[phase 14e] checkpoint round trip of phase 3's solution (B={B_MAIN}) "
        f"and its problem's first {CKPT_LANES} lanes ({size / 1e6:.1f} MB of "
        f".npz): loaded back onto the card bit for bit: {same}")
    require(same, "phase 14e: the checkpoint round trip changed a bit")
    del qp2, sol2, head

    iters = sol.info.iterations.cpu().numpy()
    lane = int(np.argmax(iters))
    text = diagnostics.solve_report(tuple(t[lane] for t in qp.tensors()), sol,
                                    lane=lane, check_interval=11)
    for line in text.rstrip().splitlines():
        log(f"[phase 14e report, lane {lane}] {line}")
    require(f"iterations : {iters[lane]}\n" in text,
            f"phase 14e: the report of lane {lane} does not name its iterations")

    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            sol_t = pkg.solve(qp, static)
            profiling.hard_sync(sol_t)
        (path,) = glob.glob(os.path.join(tmp, "*.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        n_chunk = sum(1 for e in events
                      if "admm_chunk_cluster_kernel" in str(e.get("name", ""))
                      and e.get("cat") == "kernel")
        log(f"[phase 14e] profiling.trace: {os.path.getsize(path) / 1e6:.1f} MB "
            f"Chrome trace, {len(events)} events, {n_chunk} "
            f"admm_chunk_cluster_kernel kernel events")
        require(n_chunk > 0, "phase 14e: the trace holds no chunk kernel")
    del sol_t

    lanes = [tuple(t[i].double().cpu().numpy() for t in qp.tensors())
             for i in (0, 1, 2, lane)]
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, rho=0.1, max_iterations=20000)
    t0 = time.perf_counter()
    ours = [oracle.solve_qp_reference(*ln, linsys="ldl", **kw) for ln in lanes]
    t_ldl = time.perf_counter() - t0
    refs = oracle_solves(lanes, pool, **kw)
    devs = [float(np.abs(a.x - b.x).max()) for a, b in zip(ours, refs)]
    log(f"[phase 14e] solve_qp_reference(linsys='ldl') on 4 lanes "
        f"({t_ldl:.1f} s): statuses {[r.status for r in ours]}, iterations "
        f"{[r.iterations for r in ours]} (f64_oracle {[r.iterations for r in refs]}), "
        f"max |x - x_f64_oracle| {max(devs):.3e} (limit {ORACLE_AGREEMENT:.0e})")
    require(max(devs) <= ORACLE_AGREEMENT and all(r.status == 3 for r in ours),
            "phase 14e: the native-LDL oracle disagrees with f64_oracle.py")
    del sol, qp

    insts = [generate_random_qp(ProblemClass.EQUALITY_QP, 20, seed=s)
             for s in range(8, 16)]
    fleet = pkg.stack_qps([pkg.make_qp(*d.dense(np.float32), device=DEVICE)
                           for d in insts], pad=True)
    fsol = pkg.solve(fleet, pkg.Settings(max_iterations=4000, eps_abs=1e-4,
                                         eps_rel=1e-4, rho=0.1))
    status = fsol.info.status.cpu().numpy()
    flagged = [int(i) + 8 for i in np.where(np.isin(status, (4, 5)))[0]]
    bad = feasibility.verify_status_flags(fleet.tensors(), fsol.info.status)
    log(f"[phase 14e] EQUALITY_QP n=20 seeds 8-15 on the card: statuses "
        f"{status.tolist()}, flagged infeasible at seeds {flagged}; "
        f"verify_status_flags false positives: {bad}")
    require(13 in flagged and not bad, "phase 14e: the infeasibility flags "
            f"are wrong ({flagged}, {bad})")


def phase_precision(torch, pkg, cnt):
    """Phase 14; returns 14a's and 14b's launches of PREC_KERNELS."""
    import concurrent.futures
    import multiprocessing

    t0 = time.perf_counter()
    paths = {}
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        qp = precision_fleet(torch, pkg)
        for tag, fn in (("14a", lambda: phase_precision_factor(
                             torch, pkg, cnt, pool, qp)),
                        ("14b", lambda: phase_precision_matmul(
                             torch, pkg, cnt, pool, qp)),
                        ("14c", lambda: phase_precision_products(torch, pkg, qp))):
            t1 = time.perf_counter()
            out = fn()
            if tag != "14c":
                paths.update({f"{tag} {k}": {n: v.get(n, 0) for n in PREC_KERNELS}
                              for k, v in out.items()})
            log(f"[phase {tag}] {time.perf_counter() - t1:.1f} s")
        del qp
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        phase_precision_gram_finding(torch)
        torch.cuda.empty_cache()
        log(f"[phase 14d] {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        phase_precision_utils(torch, pkg, pool)
        torch.cuda.empty_cache()
        log(f"[phase 14e] {time.perf_counter() - t1:.1f} s")
    log(f"[phase 14] {time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# Phase 15: the distributed modes (parallel/) on the card.

#: Seconds a collective of phase 15 may wait before its group raises; the
#: two-rank spawns are killed after PARALLEL_DEADLINE seconds.
PARALLEL_TIMEOUT, PARALLEL_DEADLINE = 300.0, 600.0
#: Phase 3's and phase 6's static stacks (the fleets of 15a and 15b).
ADMM_STATIC = dict(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4, rho=0.4,
                   check_interval=11, kkt_refinement_steps=0,
                   sigma_free_rhs=True, fused_factor=True, fused_chunk=True,
                   require_fused=True, adaptive_rho=False)
PROX_STATIC = dict(max_iterations=2000, eps_abs=5e-5, eps_rel=5e-5,
                   rho=0.0125, adaptive_rho=False, check_interval=25,
                   kkt_warm_start=False, kkt_refinement_steps=0,
                   sigma_free_rhs=True, fused_chunk=True, require_fused=True)
#: The block splits: bench.py's headline shape (B=64 for the 2-D mesh, one
#: lane for the 1-D split) and phase 6's prox shape, at phase 3's and phase
#: 6's static rho and eps, in the M^{-1} form (no sigma-free form there).
B_SPLIT = 64
SPLIT_SETTINGS = dict(max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4,
                      rho=0.4, adaptive_rho=False, check_interval=11)
PROX_SPLIT_SETTINGS = dict(max_iterations=2000, eps_abs=5e-5, eps_rel=5e-5,
                           rho=0.0125, adaptive_rho=False, check_interval=25,
                           kkt_warm_start=False)
#: A distributed run against its one-rank (or single-card) run: statuses
#: and iterations identical, x within these of max(|x_ref|_inf, 1)
#: (__graft_entry__.py:197-203 pins the sparse mesh at 1e-4 on x of order
#: 1). Config 4's inexact CG (cg_rel_eps 1e-4, f32) carries a sum-order
#: difference into x at ~1e-4 (the one-shard mesh against 11a's solve:
#: 1.29e-4; |x|_inf ~ 4), so the 2-shard solve also passes 11a's f64 audit.
PARALLEL_X_TOL, PARALLEL_SPARSE_X_TOL = 1e-5, 1e-4


def main_fleet(torch, B=B_MAIN):
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    return device_random_qp_fleet(B, N, M, generator=g)


def main_prox_fleet(torch, B=B_MAIN):
    from quadraticprogramsolver_tpu_torch.problems.prox_fleet import (
        device_prox_fleet)

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    return device_prox_fleet(B, N, ME, MI, generator=g)


def lane0(problem):
    """The first lane of a fleet problem, unbatched."""
    import dataclasses

    return dataclasses.replace(problem, **{
        f.name: getattr(problem, f.name)[0].contiguous()
        for f in dataclasses.fields(problem)})


def config4_scaled(pkg):
    """Config 4 (sparse_problem's generation and Ruiz) as scipy matrices:
    (data, (P, q, A, l, u) scaled, ScalingData on the card)."""
    from quadraticprogramsolver_tpu_torch.models.scaling import (
        equilibrate_sparse_host)

    data = pkg.generate_large_sparse_qp(SPARSE_N, seed=0)
    *scaled, scal = equilibrate_sparse_host(data.P, data.q, data.A, data.l,
                                            data.u, 10, device=DEVICE)
    return data, tuple(scaled), scal


def timed_run(torch, cnt, fn, path, label, factor=False, reps=3):
    """One counted run of fn (every counter at 0 before it; every kernel of
    ``path`` must launch and no witness wrapper, ``read``; with ``factor``
    the sigma-free factor's launches as ``factor_kernels`` wants them), then
    its best of ``reps``: (solution, {kernel: launches} of the path, best
    ms)."""
    reset(cnt)
    sol = fn()
    torch.cuda.synchronize()
    launches = read(cnt, path, label)
    if factor:
        factor_kernels(cnt, label)
    return sol, launches, best_seconds(torch, fn, reps) * 1e3


def host_result(sol, names=("x",)):
    """A solution's statuses, iterations and named leaves on the host."""
    out = {n: getattr(sol, n).cpu() for n in names}
    out.update(status=sol.info.status.cpu(),
               iterations=sol.info.iterations.cpu())
    return out


def held_to(label, got, ref, tol):
    """A distributed run against its reference run: statuses and iterations
    identical, max |x - x_ref| within tol of max(|x_ref|_inf, 1). Returns
    max |dx| (0.0: bit for bit)."""
    import torch

    require(torch.equal(got["status"], ref["status"]),
            f"{label}: statuses differ from the reference run")
    require(torch.equal(got["iterations"], ref["iterations"]),
            f"{label}: iterations differ from the reference run")
    dx = float((got["x"].double() - ref["x"].double()).abs().max())
    scale = max(float(ref["x"].abs().max()), 1.0)
    require(dx <= tol * scale, f"{label}: max |x - x_ref| {dx:.3e} > "
            f"{tol:.0e} x max(|x_ref|_inf, 1) = {tol * scale:.3e}")
    return dx


#: 15b's config 4 at two shards is timed by one run after its counted one:
#: at 4.3-6.6 s a solve its best of 3 took ~17 s of 15b's 37.8 (H100).
SPARSE_15B_REPS = 1


def rank_15b(sq2, scal, m_orig):
    """One of 15b's two gloo ranks on the card: each entry point's counted
    run, its best of 3 and its launches, on the host for the parent."""
    import torch
    import torch.distributed as dist

    import quadraticprogramsolver_tpu_torch as pkg
    from quadraticprogramsolver_tpu_torch.parallel import (
        consensus, mesh, prox_consensus, sparse_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cnt = counters()
    dev = torch.cuda.current_device()
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "device": f"cuda:{dev} {torch.cuda.get_device_name(dev)}"}
    # gloo's collectives on CUDA tensors: the two this package uses.
    probe = torch.full((4,), float(dist.get_rank() + 1), device=DEVICE)
    dist.all_reduce(probe, op=dist.ReduceOp.SUM)
    parts = [torch.empty_like(probe) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, probe)
    require(float(probe[0]) == 3.0 and all(float(p[0]) == 3.0 for p in parts),
            "gloo all_reduce/all_gather on CUDA tensors gave wrong values")
    out["gloo_cuda"] = "all_reduce and all_gather on CUDA tensors: ok"

    fleet = mesh.make_fleet_mesh(DEVICE)
    qp = main_fleet(torch)
    st = pkg.Settings(**ADMM_STATIC)
    label = f"phase 15b fleet rank {out['rank']}"
    sol, n, ms = timed_run(torch, cnt, lambda: mesh.solve_fleet(qp, st, fleet),
                           ADMM_PATH, label, factor=True)
    out["fleet"] = dict(host_result(sol), launches=n, ms=ms)
    del qp, sol
    prob = main_prox_fleet(torch)
    pst = pkg.ProxQPSettings(**PROX_STATIC)
    label = f"phase 15b prox fleet rank {out['rank']}"
    sol, n, ms = timed_run(
        torch, cnt, lambda: mesh.solve_prox_fleet(prob, pst, fleet), PROX_PATH,
        label, factor=True)
    out["prox fleet"] = dict(host_result(sol), launches=n, ms=ms)
    del prob, sol
    torch.cuda.empty_cache()

    blocks = mesh.make_mesh((2,), ("blocks",), DEVICE)
    qp1 = lane0(main_fleet(torch, B_SPLIT))
    st = pkg.Settings(**SPLIT_SETTINGS)
    sol, n, ms = timed_run(
        torch, cnt, lambda: consensus.solve_block_split(qp1, st, blocks), (),
        f"phase 15b block split rank {out['rank']}")
    out["block split"] = dict(host_result(sol), launches=n, ms=ms)
    prob1 = lane0(main_prox_fleet(torch, 1))
    pst = pkg.ProxQPSettings(**PROX_SPLIT_SETTINGS)
    sol, n, ms = timed_run(torch, cnt, lambda: prox_consensus.
                           solve_prox_block_split(prob1, pst, blocks), (),
                           f"phase 15b prox block split rank {out['rank']}")
    out["prox block split"] = dict(host_result(sol), launches=n, ms=ms)

    rows = mesh.make_mesh((2,), ("rows",), DEVICE)
    st = pkg.Settings(**SPARSE_SETTINGS)
    sol, n, ms = timed_run(torch, cnt, lambda: sparse_mesh.solve_sparse_mesh(
        sq2, st, rows, m_orig=m_orig, scaling=scal), ("ell_matvec",),
        f"phase 15b sparse mesh rank {out['rank']}", reps=SPARSE_15B_REPS)
    out["sparse mesh"] = dict(host_result(sol, ("x", "z", "y")), launches=n,
                              ms=ms)
    return out


def phase_parallel(torch, pkg, cnt):
    """Phase 15: the distributed modes. Returns the launches of the path
    kernels inside the distributed entry points, by run."""
    import numpy as np
    import torch.distributed as dist

    from quadraticprogramsolver_tpu_torch.parallel import (
        consensus, mesh, prox_consensus, sparse_mesh)
    from quadraticprogramsolver_tpu_torch.parallel.dryrun import (
        dryrun_multichip)
    from quadraticprogramsolver_tpu_torch.parallel.launch import (free_port,
                                                                  spawn)

    t0 = time.perf_counter()
    paths = {}
    refs = {}
    dev_name = torch.cuda.get_device_name(0)

    # 15a: this process as a one-rank NCCL world.
    mesh.init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0,
                          backend="nccl", device=DEVICE,
                          timeout=PARALLEL_TIMEOUT)
    try:
        fleet = mesh.make_fleet_mesh(DEVICE)
        for label, make, settings, entry, single, path, names in (
                ("15a fleet", main_fleet, pkg.Settings(**ADMM_STATIC),
                 mesh.solve_fleet, pkg.solve, ADMM_PATH, ("x", "z", "y")),
                ("15a prox fleet", main_prox_fleet,
                 pkg.ProxQPSettings(**PROX_STATIC), mesh.solve_prox_fleet,
                 pkg.solve_proxqp, PROX_PATH, ("x", "s", "y", "z"))):
            prob = make(torch)
            torch.cuda.synchronize()
            ref, n_ref, ms_ref = timed_run(
                torch, cnt, lambda: single(prob, settings), path,
                f"phase {label} single-card solve", factor=True)
            sol, n, ms = timed_run(
                torch, cnt, lambda: entry(prob, settings, fleet), path,
                f"phase {label}", factor=True)
            require(n == n_ref, f"phase {label}: launches {n} != the "
                    f"single-card solve's {n_ref}")
            for name in names + ("info.status", "info.iterations",
                                 "info.res_prim", "info.res_dual"):
                a, b = sol, ref
                for part in name.split("."):
                    a, b = getattr(a, part), getattr(b, part)
                require(torch.equal(a, b), f"phase {label}: {name} differs "
                        "from the single-card solve's")
            refs[label[4:]] = dict(host_result(sol), ms=ms)
            paths[f"phase_{label}"] = n
            log(f"[phase {label}] 1 NCCL rank on cuda:0 {dev_name}: B="
                f"{prob.batch_shape[0]}, {ms:.2f} ms (best of 3) beside the "
                f"single-card solve's {ms_ref:.2f} ms; x, y, z, statuses, "
                f"iterations and residuals bit for bit; launches {n} (the "
                f"single-card solve's: the same)")
            del prob, ref, sol
            torch.cuda.empty_cache()

        # The 2-D mesh at (1, 1): the block split against the single-card
        # solve at the same settings; its factor through row 2's sweep.
        qp64 = main_fleet(torch, B_SPLIT)
        st = pkg.Settings(**SPLIT_SETTINGS)
        grid = mesh.make_mesh((1, 1), ("qp", "blocks"), DEVICE)
        ref, n_ref, ms_ref = timed_run(
            torch, cnt, lambda: pkg.solve(qp64, st), ("pivot_sweep_v3",),
            "phase 15a 2-D mesh single-card solve")
        sol, n, ms = timed_run(torch, cnt, lambda: consensus.
                               solve_fleet_block_split(qp64, st, grid),
                               ("pivot_sweep_v3",), "phase 15a 2-D mesh")
        dx = held_to("phase 15a 2-D mesh", host_result(sol),
                     host_result(ref), PARALLEL_X_TOL)
        paths["phase_15a 2-D mesh"] = n
        log(f"[phase 15a 2-D mesh] (1, 1) mesh, B={B_SPLIT}: {ms:.2f} ms "
            f"(best of 3) beside the single-card solve's {ms_ref:.2f} ms; "
            f"statuses and iterations identical (p50 "
            f"{float(sol.info.iterations.float().median()):.0f}), max |dx| "
            f"{dx:.3e}; row 2 launches {n['pivot_sweep_v3']} (single card "
            f"{n_ref['pivot_sweep_v3']})")
        qp1 = lane0(qp64)
        del qp64, ref, sol

        # The one-rank block splits that 15b is held to.
        blocks = mesh.make_mesh((1,), ("blocks",), DEVICE)
        for label, fn in (
                ("block split", lambda: consensus.solve_block_split(
                    qp1, st, blocks)),
                ("prox block split", lambda: prox_consensus.
                 solve_prox_block_split(lane0(main_prox_fleet(torch, 1)),
                                        pkg.ProxQPSettings(
                                            **PROX_SPLIT_SETTINGS), blocks))):
            sol, _, ms = timed_run(torch, cnt, fn, (), f"phase 15a {label}")
            refs[label] = dict(host_result(sol), ms=ms)
            log(f"[phase 15a {label}] 1 rank: status {int(sol.info.status)},"
                f" iterations {int(sol.info.iterations)}, {ms:.2f} ms (best "
                "of 3)")

        # Config 4 as one shard, against 11a's solve.
        data, scaled, scal = config4_scaled(pkg)
        st = pkg.Settings(**SPARSE_SETTINGS)
        ell = pkg.make_sparse_qp(*scaled, dtype=np.float32, device=DEVICE)
        ref, n_ref, ms_ref = timed_run(
            torch, cnt, lambda: pkg.solve(ell, st, scaling=scal),
            ("ell_matvec",), "phase 15a 11a's solve")
        del ell
        sq1 = sparse_mesh.shard_sparse_qp(*scaled, 1, dtype=np.float32,
                                          scaling=scal, device=DEVICE)
        rows = mesh.make_mesh((1,), ("rows",), DEVICE)
        sol, n, ms = timed_run(torch, cnt, lambda: sparse_mesh.
                               solve_sparse_mesh(sq1, st, rows,
                                                 m_orig=data.m, scaling=scal),
                               ("ell_matvec",), "phase 15a sparse mesh")
        require(int(sol.info.status) == int(ref.info.status),
                f"phase 15a sparse mesh: status {int(sol.info.status)} != "
                f"11a's {int(ref.info.status)}")
        ok, _ = osqp_f64(data, sol, "phase 15a sparse mesh")
        require(ok, "phase 15a sparse mesh: the f64 audit failed")
        dx11 = float((sol.x - ref.x).abs().max())
        refs["sparse mesh"] = dict(host_result(sol), ms=ms)
        paths["phase_15a sparse mesh"] = n
        log(f"[phase 15a sparse mesh] config 4, 1 shard: status "
            f"{int(sol.info.status)}, {int(sol.info.iterations)} iterations "
            f"(11a's solve {int(ref.info.iterations)}), max |x - x_11a| "
            f"{dx11:.3e} (|x_11a|_inf {float(ref.x.abs().max()):.3f}); "
            f"{ms:.2f} ms (best of 3) beside 11a's {ms_ref:.2f} "
            f"ms; row 13 launches {n['ell_matvec']} (11a's "
            f"{n_ref['ell_matvec']})")
        del sq1, ref, sol
        sq2 = sparse_mesh.shard_sparse_qp(*scaled, 2, dtype=np.float32,
                                          scaling=scal, device="cpu")
        scal_cpu = scal.to(torch.float64, "cpu")
        m_orig = data.m
        del scaled, scal
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"[phase 15a] {time.perf_counter() - t0:.1f} s")

    # 15b: two gloo ranks on the one card, CUDA tensors.
    t1 = time.perf_counter()
    ranks = spawn(rank_15b, 2, args=(sq2, scal_cpu, m_orig), device=DEVICE,
                  backend="gloo", timeout=PARALLEL_TIMEOUT,
                  deadline=PARALLEL_DEADLINE)
    log(f"[phase 15b] {ranks[0]['gloo_cuda']} ({ranks[0]['backend']})")
    for label, tol in (("fleet", PARALLEL_X_TOL), ("prox fleet", PARALLEL_X_TOL),
                       ("block split", PARALLEL_X_TOL),
                       ("prox block split", PARALLEL_X_TOL),
                       ("sparse mesh", PARALLEL_SPARSE_X_TOL)):
        ref = {k: torch.as_tensor(v) if k in ("x", "status", "iterations")
               else v for k, v in refs[label].items()}
        devs = []
        for r in ranks:
            got = {k: torch.as_tensor(v) if k in ("x", "status", "iterations")
                   else v for k, v in r[label].items()}
            devs.append(held_to(f"phase 15b {label} rank {r['rank']}", got,
                                ref, tol))
            paths[f"phase_15b {label} rank {r['rank']}"] = got["launches"]
        same = "bit for bit" if max(devs) == 0.0 else f"max |dx| {max(devs):.3e}"
        if label == "sparse mesh":
            import types

            r0 = ranks[0][label]
            ok, _ = osqp_f64(data, types.SimpleNamespace(**{
                k: torch.as_tensor(r0[k]) for k in ("x", "z", "y")}),
                "phase 15b sparse mesh rank 0")
            require(ok, "phase 15b sparse mesh: the f64 audit failed")
        timed = ("one timed run after the counted one"
                 if label == "sparse mesh" else "best of 3")
        log(f"[phase 15b {label}] 2 gloo ranks on one card ("
            + ", ".join(f"rank {r['rank']} {r['device']} "
                        f"{r[label]['ms']:.2f} ms" for r in ranks)
            + f", {timed}) beside the one-rank run's "
            f"{refs[label]['ms']:.2f} ms: statuses and iterations identical, "
            f"{same} (|x_ref|_inf {float(ref['x'].abs().max()):.3f}); "
            "launches "
            f"{[r[label]['launches'] for r in ranks]}")
    del data
    log(f"[phase 15b] {time.perf_counter() - t1:.1f} s")

    # 15c: the dry run, two gloo ranks on the card.
    t1 = time.perf_counter()
    line = dryrun_multichip(2, device=DEVICE, backend="gloo",
                            timeout=PARALLEL_TIMEOUT)
    log(f"[phase 15c] {line}; {time.perf_counter() - t1:.1f} s")
    log(f"[phase 15] {time.perf_counter() - t0:.1f} s")
    return paths


# --- Phase 16: the benchmark harness, the blocked-Schur inverse, examples ---

#: 16a: the port's harness over its default sweep (bench/harness.py:
#: default_sweep, 9 classes x n in {20, 100}, B=64, the m=100n families
#: capped at 60 rows) at run_sweep's default settings, f32, 3 samples.
HARNESS_SAMPLES = 3
#: run_sweep's default settings (bench/harness.py), for 16a's audit.
HARNESS_SETTINGS = dict(max_iterations=4000, eps_abs=1e-4, eps_rel=1e-4,
                        rho=0.1, adaptive_rho=True)
#: 16a's audited case (the sweep's random_qp n=100).
HARNESS_AUDIT_CASE = ("RANDOM_QP", 100)
#: 16b: spd_inverse_blocked beside the Cholesky route and torch.linalg.inv
#: at shapes off the sweep's (n % 128 != 0 in f32; f64, which the card's
#: sweep does not take): (B, n, dtype). M = W W'/n + 0.1 I (cond ~ 40),
#: errors against numpy f64 inverses of BLOCKED_LANES lanes.
BLOCKED_SHAPES = ((2048, 500, "float32"), (256, 512, "float64"))
BLOCKED_LANES = 3
BLOCKED_LIMIT = {"float32": 1e-4, "float64": 1e-10}
#: 16c: the port-side examples, each run in its own process at its default
#: size on the card, all six at once, each with its own timeout (s).
EXAMPLES = ("portfolio_fleet_torch", "prox_fleet_torch",
            "monotone_smoothing_torch", "mpc_fleet_torch",
            "anderson_acceleration_torch", "diagnostics_report_torch")
EXAMPLE_TIMEOUT = 300.0


def phase_harness_sweep(torch, pkg, cnt, card, tmp):
    """16a: run_sweep over the default sweep on the card into a CSV and a
    JSONL under ``tmp``, the files' schema, device column and guards, and
    the audit of the random_qp n=100 case. Returns the sweep's launches."""
    import csv
    import dataclasses

    import numpy as np

    from quadraticprogramsolver_tpu_torch.bench import harness

    csv_path = os.path.join(tmp, "sweep.csv")
    jsonl_path = os.path.join(tmp, "sweep.jsonl")
    cases = harness.default_sweep()
    reset(cnt)
    t0 = time.perf_counter()
    results = harness.run_sweep(cases, samples=HARNESS_SAMPLES,
                                csv_path=csv_path, jsonl_path=jsonl_path,
                                verbose=False, device=DEVICE)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    read(cnt, (), "phase 16a run_sweep")
    launches = {k: cnt[k].launches for k in CORE_KERNELS}
    require(len(results) == len(cases) == 18,
            f"phase 16a: {len(results)} results for {len(cases)} cases")
    log(f"[phase 16a] run_sweep(default_sweep(), samples={HARNESS_SAMPLES}) "
        f"on {card}, f32: {sweep_s:.1f} s; per case the best of "
        f"{HARNESS_SAMPLES} solves after a warm one:")
    log(f"[phase 16a] {'class':>16} {'n':>4} {'m cap':>5} {'B':>3} "
        f"{'ms':>9} {'solves/s':>10} {'iter/s':>11} {'p50 it':>7} solved")
    table = []
    for r in results:
        c = r.case
        log(f"[phase 16a] {c.problem_class.value:>16} {c.num_elements:>4} "
            f"{c.num_constraints:>5} {c.batch:>3} "
            f"{r.best_time_sec * 1e3:9.3f} {r.solves_per_sec:10.1f} "
            f"{r.iterations_per_sec:11.1f} {r.median_iterations:7.1f} "
            f"{r.solved}/{r.total}")
        table.append({"class": c.problem_class.value, "n": c.num_elements,
                      "m_cap": c.num_constraints, "B": c.batch,
                      "ms": r.best_time_sec * 1e3,
                      "mean_ms": r.mean_time_sec * 1e3,
                      "solves_per_s": r.solves_per_sec,
                      "iterations_per_s": r.iterations_per_sec,
                      "median_iterations": r.median_iterations,
                      "solved": r.solved, "total": r.total})
    log("[phase 16a] table: " + json.dumps(table))

    # The files: CSV_COLUMNS, the card and its power limit in every row.
    with open(csv_path, newline="") as f:
        header = next(csv.reader(f))
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    require(header == harness.CSV_COLUMNS,
            f"phase 16a: CSV header {header} != CSV_COLUMNS")
    want = f"gpu:{card}"
    with open(jsonl_path) as f:
        devices = {r["device"] for r in rows} | {
            json.loads(ln)["device"] for ln in f}
    require(len(rows) == 18 and devices == {want},
            f"phase 16a: {len(rows)} CSV rows, device column {devices} "
            f"(want {want!r})")
    require({r["label"] for r in rows} == {"qps-torch"},
            "phase 16a: a row without the port's label")
    # An appended second run passes the guards; drifted files refuse.
    harness.emit_results(results, csv_path, jsonl_path, device=DEVICE)
    with open(csv_path, newline="") as f:
        require(len(list(csv.DictReader(f))) == 36,
                "phase 16a: the appended run did not land in the CSV")
    head = os.path.join(tmp, "headline.jsonl")
    best = max(results, key=lambda r: r.solves_per_sec)
    rec = {"bench": "sweep_best", "problem_class":
           best.case.problem_class.value, "num_elements":
           best.case.num_elements, "solves_per_sec": best.solves_per_sec}
    for _ in range(2):
        harness.append_headline_record(head, rec, device=DEVICE)
    drifted = os.path.join(tmp, "drifted.csv")
    with open(drifted, "w") as f:
        f.write(",".join(harness.CSV_COLUMNS[:-1]) + "\n")
    refused = []
    for what, fn in (
            ("CSV", lambda: harness.emit_results(results, drifted,
                                                 device=DEVICE)),
            ("JSONL", lambda: harness.append_headline_record(
                head, {"bench": "sweep_best"}, device=DEVICE))):
        try:
            fn()
        except ValueError as e:
            refused.append(what if "schema guard" in str(e) else None)
    require(refused == ["CSV", "JSONL"],
            f"phase 16a: drifted files refused {refused}, want both")
    log(f"[phase 16a] CSV header == CSV_COLUMNS, device column {want!r} in "
        f"all 18 rows and the JSONL's, a second run appended (36 rows), two "
        f"headline records appended, a drifted CSV and a drifted headline "
        f"record refused by the schema guard")

    # The audit of the random_qp n=100 case, the phase-4 ladder.
    cls, n = HARNESS_AUDIT_CASE
    case = next(c for c in cases if c.problem_class.name == cls
                and c.num_elements == n)
    qp = pkg.generate_batch(case.problem_class, case.batch, n,
                            case.num_constraints, seed=1234,
                            dtype=np.float32, device=DEVICE)
    base = pkg.Settings(**HARNESS_SETTINGS)
    for eps in (1e-4, 2e-5, 1e-5):
        st = dataclasses.replace(base, eps_abs=eps, eps_rel=eps)
        label = f"phase 16a {cls.lower()} n={n} eps {eps:.0e}"
        sol = pkg.solve(qp, st)
        status, iters, solved, line = stats_line(sol)
        log(f"[{label}] {line}")
        dev = audit(qp, sol.x.double().cpu().numpy(), status, iters, label,
                    required=False, prefix="phase 16a")
        if dev <= AUDIT_TARGET:
            break
    require(dev <= AUDIT_TARGET, f"phase 16a: audit {dev:.3e}")
    return launches


def phase_harness_blocked(torch):
    """16b: spd_inverse_blocked, the Cholesky route (cholesky_inverse) and
    torch.linalg.inv at off-sweep shapes: ms (best of 3 after a warm call)
    and the error against numpy f64 inverses of a few lanes."""
    import numpy as np

    from quadraticprogramsolver_tpu_torch.ops import linalg

    rows = []
    for B, n, dt_name in BLOCKED_SHAPES:
        dtype = getattr(torch, dt_name)
        g = torch.Generator(device=DEVICE).manual_seed(SEED)
        W = torch.randn((B, n, n), generator=g, device=DEVICE, dtype=dtype)
        M = torch.matmul(W, W.transpose(1, 2)) / n
        del W
        M += 0.1 * torch.eye(n, device=DEVICE, dtype=dtype)
        M = linalg.sym(M)
        idx = [0, B // 2, B - 1][:BLOCKED_LANES]
        ref = torch.from_numpy(np.linalg.inv(
            M[idx].double().cpu().numpy())).to(DEVICE)
        for name, fn in (("spd_inverse_blocked", linalg.spd_inverse_blocked),
                         ("cholesky_inverse", linalg.cholesky_inverse),
                         ("torch.linalg.inv", torch.linalg.inv)):
            with linalg.fp32_products():
                ms = best_ms(torch, lambda: fn(M))
                out = fn(M)
            err = rel_f64(out, ref, idx)
            del out
            log(f"[phase 16b] {name} ({B}, {n}, {n}) {dt_name}: {ms:.3f} ms "
                f"(best of 3), max |inv - inv_f64| / max |inv_f64| over "
                f"lanes {idx}: {err:.3e}")
            require(err <= BLOCKED_LIMIT[dt_name],
                    f"phase 16b {name} {dt_name}: error {err:.3e} > "
                    f"{BLOCKED_LIMIT[dt_name]:.0e}")
            rows.append({"fn": name, "B": B, "n": n, "dtype": dt_name,
                         "ms": ms, "rel_err": err})
        del M, ref
        torch.cuda.empty_cache()
    log("[phase 16b] table: " + json.dumps(rows))


def phase_harness_examples(tmp):
    """16c: the six examples/*_torch.py on the card at their default sizes,
    each in its own process (all started together; each with its own
    timeout); every one must exit 0. Their printed times come from runs
    that share the card and are not measurements."""
    procs = {}
    try:
        for name in EXAMPLES:
            args = [sys.executable, os.path.join(HERE, "examples", f"{name}.py")]
            if name == "diagnostics_report_torch":
                args += ["--out", os.path.join(tmp, "qp_report")]
            log_f = open(os.path.join(tmp, f"{name}.log"), "w+")
            procs[name] = (subprocess.Popen(args, cwd=HERE, stdout=log_f,
                                            stderr=subprocess.STDOUT),
                           log_f, time.perf_counter())
        failed = []
        for name, (proc, log_f, t0) in procs.items():
            try:
                rc = proc.wait(timeout=max(1.0, EXAMPLE_TIMEOUT - (
                    time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rc = "timeout"
            log_f.seek(0)
            lines = log_f.read().splitlines()
            for line in lines[-40:]:
                log(f"[phase 16c {name}] {line}")
            log(f"[phase 16c {name}] rc {rc}, "
                f"{time.perf_counter() - t0:.1f} s")
            if rc != 0:
                failed.append((name, rc))
    finally:
        for proc, log_f, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_f.close()
    require(not failed, f"phase 16c: examples failed {failed}")


def phase_harness(torch, pkg, cnt, card):
    """Phase 16; returns 16a's launches of the path kernels."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        launches = phase_harness_sweep(torch, pkg, cnt, card, tmp)
        torch.cuda.empty_cache()
        log(f"[phase 16a] {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        phase_harness_blocked(torch)
        log(f"[phase 16b] {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        phase_harness_examples(tmp)
        log(f"[phase 16c] {time.perf_counter() - t1:.1f} s")
    log(f"[phase 16] {time.perf_counter() - t0:.1f} s")
    return {"16a": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (os.path.isdir(os.path.join(HERE, PKG, "csrc"))
            and os.path.isfile(os.path.join(HERE, "f64_oracle.py"))):
        print(f"chip_smoke: {PKG}/csrc or f64_oracle.py not found beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import quadraticprogramsolver_tpu_torch as pkg
    from quadraticprogramsolver_tpu_torch import _build
    from quadraticprogramsolver_tpu_torch.ops import fused_admm
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

    if "--core-only" in sys.argv[1:]:
        core_paths = phase_core(torch, pkg, counters())
        log(f"chip_smoke: total wall time {time.perf_counter() - T0:.1f} s")
        print(json.dumps({"paths": core_paths}))
        print(card)
        return 0

    if "--kkt-only" in sys.argv[1:]:
        kkt_paths = phase_kkt(torch, pkg, counters())
        log(f"chip_smoke: total wall time {time.perf_counter() - T0:.1f} s")
        print(json.dumps({"paths": kkt_paths}))
        print(card)
        return 0

    if "--precision-only" in sys.argv[1:]:
        prec_paths = phase_precision(torch, pkg, counters())
        log(f"chip_smoke: total wall time {time.perf_counter() - T0:.1f} s")
        print(json.dumps({"paths": prec_paths}))
        print(card)
        return 0

    if "--parallel-only" in sys.argv[1:]:
        par_paths = phase_parallel(torch, pkg, counters())
        log(f"chip_smoke: total wall time {time.perf_counter() - T0:.1f} s")
        print(json.dumps({"paths": par_paths}))
        print(card)
        return 0

    if "--harness-only" in sys.argv[1:]:
        harness_paths = phase_harness(torch, pkg, counters(), card)
        log(f"chip_smoke: total wall time {time.perf_counter() - T0:.1f} s")
        print(json.dumps({"paths": harness_paths}))
        print(card)
        return 0

    if "--sparse-only" in sys.argv[1:]:
        entries = phase_sparse(torch, pkg, counters(),
                               "--profile" in sys.argv[1:])
        log(f"chip_smoke: total wall time {time.perf_counter() - T0:.1f} s")
        print(json.dumps({"kernels": entries}))
        print(card)
        return 0

    # Phase 2: every kernel against its plain version.
    extra = {}  # further numbers of the ENTRY_KERNELS, by kernel
    kstats = phase_kernels(torch, extra)
    for name, numbers in phase_redesigns(torch).items():
        extra.setdefault(name, {}).update(numbers)
    if "--time-chunks" in sys.argv[1:]:
        time_chunks(torch)
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
    torch.cuda.reset_peak_memory_stats()
    reset(cnt)
    sol = pkg.solve(qp, static)
    torch.cuda.synchronize()
    launches = read(cnt, ADMM_PATH, "phase 3 main-path solve", witnesses=True)
    factor_kernels(cnt, "phase 3 main-path solve")
    log(f"[phase 3 main-path solve] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    launches.update(chunk_kernels(
        cnt, "admm_chunk", fused_admm.chunk_kernel(N, M, 1, "highest", "G"),
        "phase 3 main-path solve"))
    del sol
    if "--profile" in sys.argv[1:]:
        profile_solve(torch, lambda: pkg.solve(qp, static), "phase 3 profile",
                      factor=True)
    for settings, label in ((static, "phase 3 static rho"),
                            (adaptive, "phase 3 adaptive rho")):
        sol, dt = run_main(torch, lambda: pkg.solve(qp, settings))
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
    sol, dt = run_main(torch, lambda: pkg.solve(qp, static))
    fdt = factor_seconds(torch, pkg.pad_qp(qp, 512, 256), static)
    x, status, iters = report_solve(qp, sol, dt, fdt,
                                    "phase 5 500/250 static rho")
    del sol
    audit(qp, x, status, iters, "phase 5 500/250 static rho")
    del qp

    # Phase 6: the prox-ALM family.
    prox_launches = phase_prox(torch, pkg, cnt, "--profile" in sys.argv[1:])

    # Phase 7: the M^{-1} form (default settings) of both families.
    minv_launches = phase_minv(torch, pkg, cnt, "--profile" in sys.argv[1:])
    paths = {"admm": launches, "prox": prox_launches, **minv_launches}

    # Phase 8: bench.py's tuned stacks and the M^{-1} chunks' lanes.
    stacks = phase_stacks(torch, pkg, cnt, "--profile" in sys.argv[1:])
    paths.update({f"phase_{k}": v["kernels"] for k, v in stacks.items()})

    # Phase 9: the fused factor's knobs (pivot formulations, bf16x3 level).
    knobs = phase_factor_knobs(torch, pkg, cnt, base, "--profile" in sys.argv[1:])
    paths.update({f"phase_{k}": v["kernels"] for k, v in knobs.items()})

    # Phase 10: the SPD-inverse entry points (rows 6, 11, 12) and the TF32
    # scope of a solve.
    entry_launches = phase_entry_points(torch, pkg, cnt, extra)

    # Phase 11: the large sparse path (BASELINE config 4) and the SpMV
    # kernels of rows 13-15.
    config4 = sparse_problem(pkg)
    sparse_entries = phase_sparse(torch, pkg, cnt, "--profile" in sys.argv[1:],
                                  config4)

    # Phase 12: Ruiz scaling, Anderson, polish and factor reuse at the JAX
    # package's user-facing settings.
    core_paths = phase_core(torch, pkg, cnt)
    paths.update({f"phase_{k}": v for k, v in core_paths.items()})

    # Phase 13: the KKT_LDL and KKT_MINRES backends, the MINRES polish and
    # the matrix-free prox path.
    kkt_paths = phase_kkt(torch, pkg, cnt, config4)
    del config4

    # Phase 14: reduced product precision and the host utilities.
    prec_paths = phase_precision(torch, pkg, cnt)

    # Phase 15: the distributed modes (one NCCL rank, two gloo ranks on the
    # card, the dry run); their kernel launches join the kernels line.
    par_paths = phase_parallel(torch, pkg, cnt)
    paths.update(par_paths)

    # Phase 16: the benchmark harness, the blocked-Schur inverse and the
    # port-side examples.
    harness_paths = phase_harness(torch, pkg, cnt, card)
    paths.update(harness_paths)
    for e in sparse_entries:
        if e["name"] == "ell_matvec":
            e["launches_by_path"] = {k: v["ell_matvec"]
                                     for k, v in par_paths.items()
                                     if "ell_matvec" in v}

    def entry(name, src, rep):
        err, ms, pms, lms, (bms, by) = kstats[name]
        by_path = {k: v.get(name) for k, v in paths.items()}
        own = {"prox_chunk": "prox", "prox_chunk_cluster": "prox",
               "admm_chunk_minv": "admm_minv",
               "admm_chunk_minv_cluster": "admm_minv",
               "prox_chunk_minv": "prox_minv",
               "prox_chunk_minv_cluster": "prox_minv"}.get(name, "admm")
        e = {"name": name, "route": "cuda", "source": f"{PKG}/{src}",
             "replaces": rep,
             # Its own path's count: the ADMM path's for the factor kernels,
             # each chunk's own family and form otherwise (0 for a kept
             # previous kernel, which no solver launches).
             "launches": paths[own].get(name, 0),
             "launches_by_path": {k: v for k, v in by_path.items()
                                  if v is not None},
             "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bms,
             "bound_by": by, "library_ms": lms, **extra.get(name, {})}
        if name in WITNESSES:
            e["witness_of"] = WITNESSES[name]
        if name == "slab_build":
            err2, ms2, pms2, _, (bms2, by2) = kstats["slab_build_two_block"]
            e["two_block"] = {"max_abs_err": err2, "ms": ms2, "plain_ms": pms2,
                              "bound_ms": bms2, "bound_by": by2}
        return e

    def variant_entry(name, base, stack, token):
        err, ms, pms, lms, (bms, by) = kstats[name]
        src, rep = KERNELS[base]
        # Its stack's launches of this variant (every launch whose key has
        # the variant's precision, G source or lane count).
        n = sum(v for k, v in stacks[stack]["variants"].items()
                if token in f",{k},")
        return {"name": name, "route": "cuda", "source": f"{PKG}/{src}",
                "replaces": rep, "variant_of": base, "stack": f"phase {stack}",
                "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": pms,
                "bound_ms": bms, "bound_by": by, "library_ms": lms,
                **extra.get(name, {})}

    def factor_entry(name, src, rep, stack, key):
        err, ms, pms, lms, (bms, by) = kstats[name]
        run = knobs[stack]
        n = run["level" if key == "high" else "pivot"].get(key, 0)
        return {"name": name, "route": "cuda", "source": f"{PKG}/{src}",
                "replaces": rep,
                "variant_of": "slab_level" if key == "high" else "pivot_sweep_v3",
                "stack": f"phase {stack}", "launches": n, "max_abs_err": err,
                "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "library_ms": lms, **extra.get(name, {})}

    kernels = [entry(name, src, rep) for name, (src, rep) in KERNELS.items()]
    kernels += [variant_entry(name, *v) for name, v in VARIANTS.items()]
    kernels += [factor_entry(name, *v) for name, v in FACTOR_VARIANTS.items()]
    for name, (src, rep) in ENTRY_KERNELS.items():
        err, ms, pms, lms, (bms, by) = kstats[name]
        kernels.append({"name": name, "route": "cuda", "source": f"{PKG}/{src}",
                        "replaces": rep, "stack": "phase 10",
                        "launches": entry_launches[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": pms, "bound_ms": bms,
                        "bound_by": by, "library_ms": lms, **extra[name]})
    for name, (src, rep, tags) in ENTRY_WITNESSES.items():
        err, ms, pms, lms, (bms, by) = kstats[name]
        n = (sum(knobs[t]["witnesses"][name] for t in tags) if tags
             else entry_launches[name])
        kernels.append({"name": name, "route": "cuda", "source": f"{PKG}/{src}",
                        "replaces": rep, "witness_of": WITNESSES[name],
                        "stack": "phase " + ("/".join(tags) if tags else "10"),
                        "launches": n, "max_abs_err": err,
                        "ms": ms, "plain_ms": pms, "bound_ms": bms,
                        "bound_by": by, "library_ms": lms,
                        **extra.get(name, {})})
    kernels += sparse_entries
    log(f"chip_smoke: total wall time {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"paths": {**core_paths, **kkt_paths, **prec_paths,
                                **par_paths, **harness_paths}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
