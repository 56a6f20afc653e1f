"""The numbers that decide `correct`: gaps between what the timed path
produced and the plain reference (benchmark/reference), each a float that
a limit bounds from above.

  - residual_norm: the reference's residual norm (sqrt of the sum over
    cells of the energy residual squared times the area) of a state: a
    converged solve's answer must be a steady state of the reference's
    discretization;
  - functional_gap: the largest of |CL - CL_ref|, |CDp - CDp_ref| and
    |entropy - entropy_ref| / entropy_ref, the program's functionals of a
    state against the reference's of the same state;
  - step_gaps: for recorded implicit steps (input state, cfl, omega cap,
    the program's Krylov iterations, its reported residual and the state
    it produced), res_gap = |res - res_ref| / res_ref, the residual norm
    at the input, and step_gap = |u' - u'_ref| / |u'_ref - u|, the state
    produced against the reference's step from the same input with as
    many Krylov iterations (2-norms over all cells and components).
"""

from __future__ import annotations

import torch

from .reference.krylov import implicit_step


def residual_norm(flow, u) -> float:
    return float(flow.residual_norm(flow.residual(u)[0]))


def functional_gap(flow, u, fnl) -> float:
    ent, cl, cdp = (float(x) for x in flow.functionals(u))
    return max(abs(fnl[1] - cl), abs(fnl[2] - cdp),
               abs(fnl[0] - ent) / ent)


def step_gaps(flow, steps, nelem: int, plain: dict,
              lower_precision: bool = False) -> dict:
    """max res_gap and step_gap over `steps` (dicts of u, unew, cfl,
    omega_cap, res, iters; states (>= nelem, 4)). `lower_precision`: the
    reference step with its residual in f32 and its Jacobian and Krylov
    solve in bf16 (the control)."""
    out = dict(res_gap=0.0, step_gap=0.0)
    kw = (dict(residual_dtype=torch.float32, krylov_dtype=torch.bfloat16)
          if lower_precision else {})
    for s in steps:
        u = s["u"][:nelem].double()
        unew = s["unew"][:nelem].double()
        uref, rhs = implicit_step(flow, u, s["cfl"], s["iters"],
                                  plain["restart"], plain["pc_sweeps"],
                                  s["omega_cap"], **kw)
        uref = uref.double()
        res = float(flow.residual_norm(rhs.double()))
        out["res_gap"] = max(out["res_gap"], abs(s["res"] - res) / res)
        out["step_gap"] = max(out["step_gap"], float(
            torch.linalg.vector_norm(unew - uref)
            / torch.linalg.vector_norm(uref - u)))
    return out
