"""The layers' counts against hand-computed ones, and their independence
from which kernel names implement a layer."""

import math

import pytest
import torch

from qpbench import harness, tracing


def _run(device_ms, cell="admm_rqp.n512.b4096.fused", shape=None, iters=None):
    spec = harness.load_cell(cell, {"batch": 2, "shape": shape or {"n": 4, "m": 2}})
    run = harness.Run(cell=spec, setup_s=1.0)
    run.trace = tracing.Trace(solves=2, window_s=1.0, busy_s=0.5,
                              device_ms=device_ms, idle_gaps=[])
    run.traced_iterations = iters or [torch.tensor([11, 22]), torch.tensor([33, 11])]
    return run


def test_factor_count_by_hand():
    factor = harness.reader("factor.roofline_pct")
    # n = 4, m = 2: gram 4*5*2 = 40, factorisation 64/3, solves 2*16*3 = 96;
    # bytes 4*(16 + 8 + 4) + 4*10 = 152.
    flops, nbytes = factor.lane_work(4, 2)
    assert flops == pytest.approx(40 + 64 / 3 + 96)
    assert nbytes == 152


def test_chunk_count_by_hand():
    chunk = harness.reader("chunk.roofline_pct")
    # n = 4, m = 2, 11 iterations: 11*(2*16 + 4*2*4) = 704; 4*(10 + 8) = 72.
    assert chunk.lane_chunk_work(4, 2, 11) == (704, 72)


def test_shares_read_the_work_whatever_kernel_implements_the_layer():
    factor = harness.reader("factor.roofline_pct")
    chunk = harness.reader("chunk.roofline_pct")
    a = _run({"slab_build_kernel(float*)": 1.0, "level_strip_kernel(float*)": 2.0,
              "pivot_sweep_v3_kernel(float*)": 1.0,
              "void admm_chunk_cluster_kernel<0>(float*)": 3.0})
    b = _run({"slab_build_kernel(float*)": 1.0, "level_strip_kernel_high(float*)": 2.0,
              "pivot_sweep_v3_kernel(float*)": 1.0,
              "void admm_chunk_kernel<1>(float*)": 3.0,
              "some_new_kernel(float*)": 5.0})
    for mod in (factor, chunk):
        assert mod.read(a) == pytest.approx(mod.read(b))
    flops, nbytes = factor.lane_work(4, 2)
    least = 2 * 2 * max(nbytes / factor.BYTES_PER_S, flops / factor.FLOPS_PER_S)
    assert factor.read(a) == pytest.approx(100 * least / 4e-3)
    # Lanes ran 11, 22 / 33, 11 iterations at 11 a chunk: 1 + 2 + 3 + 1 chunks.
    cf, cb = chunk.lane_chunk_work(4, 2, 11)
    least = 7 * max(cb / chunk.BYTES_PER_S, cf / chunk.FLOPS_PER_S)
    assert chunk.read(a) == pytest.approx(100 * least / 3e-3)
    torch_ops = harness.reader("torch_ops.device_ms")
    assert torch_ops.read(a) is None and torch_ops.read(b) == pytest.approx(2.5)


def test_split_form_counts_both_constraint_blocks():
    factor = harness.reader("factor.roofline_pct")
    a = _run({"level_strip_kernel": 1.0}, cell="prox.n512.b4096.fused",
             shape={"n": 4, "me": 1, "mi": 1})
    flops, nbytes = factor.lane_work(4, 2)
    least = 2 * 2 * max(nbytes / factor.BYTES_PER_S, flops / factor.FLOPS_PER_S)
    assert factor.read(a) == pytest.approx(100 * least / 1e-3)


def test_readers_find_nothing_without_a_trace():
    run = _run({})
    run.trace = None
    for m in ("factor.device_ms", "factor.roofline_pct", "chunk.device_ms",
              "chunk.roofline_pct", "torch_ops.device_ms", "device_idle_pct"):
        assert harness.reader(m).read(run) is None
    assert math.isclose(harness.reader("setup_s").read(run), 1.0)
