"""The frozen copies in qpbench/traffic and qpbench/reference against the
originals they were copied from, at one seed, and the batched reference
in float64 against the scalar one."""

import numpy as np
import torch

from qpbench.reference import osqp_batched, osqp_f64
from qpbench.traffic import prox_split, random_qp


def test_random_qp_is_the_port_generator_bit_for_bit():
    from quadraticprogramsolver_tpu_torch.problems.device_fleet import (
        device_random_qp_fleet)

    a = random_qp.fleet(3, 24, 12, generator=torch.Generator().manual_seed(7))
    b = device_random_qp_fleet(3, 24, 12, generator=torch.Generator().manual_seed(7))
    for k in "PqAlu":
        assert a[k].equal(getattr(b, k)), k


def test_prox_split_is_the_port_generator_bit_for_bit():
    from quadraticprogramsolver_tpu_torch.problems.prox_fleet import device_prox_fleet

    a = prox_split.fleet(3, 24, 6, 6, generator=torch.Generator().manual_seed(7))
    b = device_prox_fleet(3, 24, 6, 6, generator=torch.Generator().manual_seed(7))
    for k in "PqAbCd":
        assert a[k].equal(getattr(b, k)), k


def _lane(seed=3, n=40, m=20):
    f = random_qp.fleet(1, n, m, generator=torch.Generator().manual_seed(seed),
                        dtype=torch.float64)
    return [f[k][0].numpy() for k in "PqAlu"]


def test_reference_is_f64_oracle():
    import f64_oracle

    lane = _lane()
    a = osqp_f64.solve_qp_reference(*lane, eps_abs=1e-9, eps_rel=1e-9)
    b = f64_oracle.solve_qp_reference(*lane, eps_abs=1e-9, eps_rel=1e-9)
    assert a.status == b.status == 3 and a.iterations == b.iterations
    np.testing.assert_array_equal(a.x, b.x)


def test_batched_reference_in_float64_is_the_scalar_one():
    f = random_qp.fleet(3, 40, 20, generator=torch.Generator().manual_seed(9),
                        dtype=torch.float64)
    out = osqp_batched.solve_fleet(*(f[k] for k in "PqAlu"), precision="float64",
                                   eps_abs=1e-9, eps_rel=1e-9, max_iterations=20000)
    for i in range(3):
        ref = osqp_f64.solve_qp_reference(*(f[k][i].numpy() for k in "PqAlu"),
                                          eps_abs=1e-9, eps_rel=1e-9)
        assert int(out["status"][i]) == ref.status == 3
        assert int(out["iterations"][i]) == ref.iterations
        np.testing.assert_allclose(out["x"][i].numpy(), ref.x, atol=1e-8)


def test_configuration_files_state_what_the_generators_draw():
    import json

    from conftest import ROOT
    from qpbench import harness

    box = json.loads((ROOT / "qpbench/configs/admm_random_qp.json").read_text())
    assert box["density"] == random_qp.DENSITY and box["p_shift"] == random_qp.P_SHIFT
    assert box["eq_row_share"] == random_qp.EQ_ROW_SHARE
    assert box["u_one_row_share"] == random_qp.U_ONE_ROW_SHARE
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        shape, cfg = cell.traffic["shape"], cell.config
        if cfg["form"] == "box":
            assert shape["m"] == int(cfg["m_per_n"] * shape["n"]), w["name"]
        else:
            assert shape["me"] == int(cfg["me_per_n"] * shape["n"]), w["name"]
            assert shape["mi"] == int(cfg["mi_per_n"] * shape["n"]), w["name"]
    for c in bench["configs"]:
        keys = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(keys), c["name"]
