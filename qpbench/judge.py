"""What decides ``correct``: the answers of the timed path held to the
optimality conditions of the problem the benchmark made, worked out again in
float64.

``kkt_ratio``, beside its limit from the cell's traffic file: over every lane
of every fleet, the largest of three residuals, each over its tolerance,
redone in float64 from the inputs that the benchmark made and the
primal-dual point that the program returned:

- primal: the family's primal residual (box bounds of z, and the true
  violation ``(Cx - d)+`` of the split form), over the configuration's primal
  tolerance;
- dual: the family's dual residual (and ``z >= 0`` of the split form's
  inequality duals), over its dual tolerance;
- complementarity, over the primal tolerance: for the box form
  ``|z - proj_[l,u](z + y)|``, which is nought only where y lies in the
  normal cone of [l, u] at z; for the split form ``|min(z, d - Cx)|``.

The first two are the configuration's stopping test, which a lane that meets
it reads at most about 1 (up to the FP32 rounding of the program's own
check). The third catches a point that is feasible and stationary for a
tighter problem than the one made (bounds moved inward, a kernel that
projects onto the wrong box): such a point holds a multiplier on a
constraint that is not active. A lane whose answer never came (status 0),
that calls its problem infeasible (status 4, 5: every problem the
generators make is feasible and strictly convex) or whose point is not
finite reads infinity.

Everything here is plain torch, run after the window.
"""

from __future__ import annotations

import math

import torch

#: Lanes the residual check takes into float64 at once.
BLOCK = 256


def _inf(v):
    return v.abs().amax(-1)


def _mv(M, v):
    return torch.bmm(M, v.unsqueeze(-1)).squeeze(-1)


def _mtv(M, v):
    return torch.bmm(M.transpose(1, 2), v.unsqueeze(-1)).squeeze(-1)


def kkt_ratio_box(prob: dict, out: dict, eps_abs: float, eps_rel: float,
                  lanes: slice) -> torch.Tensor:
    """OSQP's test and complementarity in float64 for lanes ``lanes`` of a
    box-form fleet."""
    P, q, A, l, u = (prob[k][lanes].double() for k in "PqAlu")
    x, z, y = (out[k][lanes].double() for k in "xzy")
    Ax, Px, Aty = _mv(A, x), _mv(P, x), _mtv(A, y)
    outside = torch.clamp(torch.maximum(l - z, z - u), min=0.0)
    r_prim = torch.maximum(_inf(Ax - z), _inf(outside))
    r_dual = _inf(Px + q + Aty)
    r_comp = _inf(z - torch.clamp(z + y, l, u))
    e_prim = eps_abs + eps_rel * torch.maximum(_inf(Ax), _inf(z))
    e_dual = eps_abs + eps_rel * torch.stack([_inf(Px), _inf(Aty),
                                              _inf(q)]).amax(0)
    return torch.stack([r_prim / e_prim, r_dual / e_dual,
                        r_comp / e_prim]).amax(0)


def kkt_ratio_split(prob: dict, out: dict, eps_abs: float, eps_rel: float,
                    lanes: slice) -> torch.Tensor:
    """The split form's test in float64 (PIQP's criteria on the true
    constraint violation, not on the program's slack) and complementarity."""
    P, q, A, b, C, d = (prob[k][lanes].double() for k in "PqAbCd")
    x, y, z = (out[k][lanes].double() for k in "xyz")
    Ax, Cx, Px = _mv(A, x), _mv(C, x), _mv(P, x)
    Aty, Ctz = _mtv(A, y), _mtv(C, z)
    r_prim = torch.maximum(_inf(Ax - b), _inf(torch.clamp(Cx - d, min=0.0)))
    r_dual = torch.maximum(_inf(Px + q + Aty + Ctz),
                           _inf(torch.clamp(-z, min=0.0)))
    r_comp = _inf(torch.minimum(z, d - Cx))
    e_prim = eps_abs + eps_rel * torch.stack(
        [_inf(Ax), _inf(b), _inf(Cx), _inf(d)]).amax(0)
    e_dual = eps_abs + eps_rel * torch.stack(
        [_inf(Px), _inf(Aty), _inf(Ctz), _inf(q)]).amax(0)
    return torch.stack([r_prim / e_prim, r_dual / e_dual,
                        r_comp / e_prim]).amax(0)


KKT_RATIO = {"box": kkt_ratio_box, "split": kkt_ratio_split}


def judge_fleet(prob: dict, out: dict, *, form: str, eps_abs: float,
                eps_rel: float) -> dict:
    """The numbers over one fleet: {name: value}."""
    status = out["status"]
    bad = (status == 0) | (status >= 4)
    ratio = 0.0
    for s in range(0, status.shape[0], BLOCK):
        lanes = slice(s, s + BLOCK)
        r = KKT_RATIO[form](prob, out, eps_abs, eps_rel, lanes)
        r = torch.where(torch.isnan(r) | bad[lanes].to(r.device),
                        torch.full_like(r, math.inf), r)
        ratio = max(ratio, float(r.max()))
    return {"kkt_ratio": ratio}


def worst(rows: list[dict]) -> dict:
    """Each number's largest reading over ``rows``."""
    return {k: max(r[k] for r in rows) for k in rows[0]}


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number is within its limit."""
    return all(numbers[k] <= limits[k] for k in limits)
