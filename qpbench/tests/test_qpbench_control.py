"""The control, reference/osqp_batched.py at TF32 in the program's place,
comes out not correct on every cell's fleets, where the program comes out
correct (at a size the CPU holds; the chip reads both at the cells' own
sizes with qpbench/control.py)."""

import pytest
import torch

from conftest import CELLS, small
from qpbench import control, harness, judge
from qpbench.reference import osqp_batched


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell, no_card):
    spec = harness.load_cell(cell, small(cell))
    limits = spec.traffic["limits"]
    for seed in (2**31 + 31, 2**31 + 32):
        fleets = harness.make_fleets(spec, seed, no_card)
        Problem, settings, solve, names = harness.solver(spec)
        outs = [harness.outputs(solve(Problem(**f), settings), names) for f in fleets]
        assert judge.verdict(harness.compare(spec, fleets, outs), limits)
        numbers = harness.compare(spec, fleets,
                                  [control.control_output(spec, f) for f in fleets])
        assert not judge.verdict(numbers, limits), numbers


def test_round_tf32_keeps_ten_mantissa_bits_to_nearest_even():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      1.0 + 2**-11 + 2**-20, -1.0 - 2**-11 - 2**-20])
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9,
                         1.0 + 2**-10, -1.0 - 2**-10])
    assert osqp_batched.round_tf32(x).equal(want)
