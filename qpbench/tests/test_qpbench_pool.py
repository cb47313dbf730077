"""Every seed solves one pool of problems: the same seed makes the same
fleets, another seed the pool's fleets in another order and turned by other
signs, and a turned lane takes the solver the same iterations to the same
optimum, its answer turned by the same signs."""

import pytest
import torch

from conftest import CELLS, small
from qpbench import harness


def test_seed_makes_the_same_fleets_and_another_seed_the_pool_turned(no_card):
    cell = harness.load_cell(CELLS[0], dict(small(CELLS[0]), fleets=4))
    a = harness.make_fleets(cell, 2**31 + 5, no_card)
    b = harness.make_fleets(cell, 2**31 + 5, no_card)
    c = harness.make_fleets(cell, 2**33 + 6, no_card)
    assert all(all(x[k].equal(y[k]) for k in x) for x, y in zip(a, b))
    ra, rc = harness.rotation(cell, 2**31 + 5), harness.rotation(cell, 2**33 + 6)
    assert sorted(ra) == sorted(rc) == list(range(4)) and ra != rc
    for k, j in enumerate(ra):
        other = c[rc.index(j)]
        assert a[k]["P"].abs().equal(other["P"].abs())
        assert a[k]["A"].abs().equal(other["A"].abs())
        assert not a[k]["P"].equal(other["P"])
    assert not a[0]["P"].abs().equal(a[1]["P"].abs())


@pytest.mark.parametrize("cell", CELLS)
def test_a_turned_lane_takes_the_same_iterations_to_the_turned_answer(cell, no_card):
    spec = harness.load_cell(cell, small(cell))
    gen = harness.load_module(harness.HERE / "traffic" / f"{spec.config['generator']}.py")
    Problem, settings, solve, names = harness.solver(spec)
    f = gen.fleet(spec.traffic["batch"],
                  **spec.traffic["shape"], generator=torch.Generator().manual_seed(5))
    turned = gen.orient({k: v.clone() for k, v in f.items()},
                        generator=torch.Generator().manual_seed(6))
    assert not turned["P"].equal(f["P"]) and not turned["q"].equal(f["q"])
    s0, s1 = solve(Problem(**f), settings), solve(Problem(**turned), settings)
    assert s1.info.iterations.equal(s0.info.iterations)
    assert s1.info.status.equal(s0.info.status)
    # x -> Dx, bit for bit: the same magnitudes, and the signs of q's turn.
    assert s1.x.abs().equal(s0.x.abs())
    d = turned["q"] / f["q"]
    assert (s1.x * d).equal(s0.x)
