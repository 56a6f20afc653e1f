"""Where one implicit step of a solve spends its time.

    python -m fvens_tpu_torch.cases.profile_step [--case bench|cylinder]

`bench` (the default) is the bench solve of cases/bench_case.py on its
naca0012_omesh(160, 80); `cylinder` is the main solve of
cases/bigmesh_case.py on its 640x320 mesh, after the first-order starter.
Runs WARM_STEPS steps, once through the CUDA kernels and once through the
plain banded twins (pallas=False; blocked GMRES's basis appends stay the
row_set kernel, which, as in the JAX package, no option turns off), then
at that state:

  1. times each phase of one step with the host clock around work that
     ends in a device synchronisation, median of 5 (GMRES and the step:
     of 3): the residual, the Jacobian with its pseudo-time term, the
     banded operators, one matvec, one preconditioner apply, the GMRES
     solve and the whole step. Where gmres runs blocked, also one blocked
     MGS pass over the mean number of filled basis rows of that solve,
     one basis append (row_set) and one host copy of two norms, median
     of 20;
  2. traces one step with torch.profiler and prints the device time by
     kernel and the device's busy time (the sum over device events, so
     the operators that launched them are not counted twice) against the
     traced wall time.

Each prints one JSON line ("phases", "trace"). `profile()` also runs on
CPU tensors, where it measures host time only.
"""

from __future__ import annotations

import json
import time

import torch

from ..solver import banded_kernels as bk
from ..solver import jacobian as jacmod
from ..solver import linear
from ..solver import rowset_kernels as rk
from ..solver.linear import gmres
from ..solver.steady import banded_operators
from . import bigmesh_case
from .bench_case import BENCH_MESH, bench_solver
from .casesolvers import build_space, initial_state

# past the first transient (bench: CFL ~60, 13 Krylov iterations with the
# kernel; cylinder: CFL ~1,860, 56 iterations)
WARM_STEPS = 20
MESHES = {"bench": BENCH_MESH, "cylinder": bigmesh_case.BIGMESH}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sync_ms(dev, fn, reps=5):
    """(median host ms of fn() over `reps` synchronised calls, its result),
    after one warm-up call."""
    out = fn()
    _sync(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2] * 1e3, out


def _device_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def _on_device(e):
    return e.device_type == torch.autograd.DeviceType.CUDA


def _warm_state(dev, case: str, mesh, warm: int, pallas: bool):
    """(main solver, mesh, state after `warm` main steps, SolveInfo)."""
    if case == "bench":
        solver, cm = bench_solver(dev, mesh=mesh, pallas=pallas)
        u = initial_state(solver.space, cm)
    else:
        fcase, cm, u = bigmesh_case.build_case(dev, *mesh, pallas=pallas)
        u = fcase.execute_starter(cm, u)
        solver = fcase._make_solver(build_space(fcase.cfg), fcase.cfg.main)
    u, info = solver.solve(cm, u, max_steps=warm)
    return solver, cm, u, info


def profile(dev, mesh, warm: int, pallas: bool, case: str = "bench"):
    """Phase times and a one-step trace of the `case` solve ("bench":
    naca0012_omesh `mesh`; "cylinder": cylinder_omesh `mesh`, main solve)
    after `warm` steps, through the kernels (`pallas`) or the twins."""
    solver, cm, u, info = _warm_state(dev, case, mesh, warm, pallas)
    cfl, rtol = info.history[-1][3], solver.lin.rtol
    bl = solver._banded(cm)
    lmesh = cm.to(torch.float32)
    sp = solver.space
    rec = dict(case=case, mesh=list(mesh), pallas=pallas, warm_steps=warm,
               cfl=cfl)
    rec["residual_ms"], (rhs, dt) = sync_ms(
        dev, lambda: sp.compute_residual(cm, u, True))
    lu, lrhs, ldt = u.float(), rhs.float(), dt.float()
    rec["jacobian_ms"], jac = sync_ms(dev, lambda: jacmod.add_pseudotime_term(
        lmesh, sp.assemble_jacobian(lmesh, lu), cfl, ldt))
    rec["operators_ms"], ops = sync_ms(dev, lambda: banded_operators(bl, jac))
    mv, pc = solver._linear_operators(ops)
    rec["matvec_ms"], _ = sync_ms(dev, lambda: mv(lrhs), 50)
    rec["pc_ms"], _ = sync_ms(dev, lambda: pc(lrhs), 50)
    rec["gmres_ms"], (_, its, _) = sync_ms(dev, lambda: gmres(
        mv, lrhs, torch.zeros_like(lrhs), pc, restart=solver.lin.restart,
        maxiter=solver.lin.maxiter, rtol=rtol), 3)
    rec["gmres_iters"] = its
    rec["gmres_ms_per_iter"] = rec["gmres_ms"] / max(its, 1)
    n = lrhs.numel()
    rec["blocked"] = n >= linear._BLOCKED_N_THRESHOLD
    if rec["blocked"]:
        # the basis work of one iteration at the solve's mean filled rows
        m = solver.lin.restart
        mpad = -(-(m + 1) // linear._ROW_BLOCK) * linear._ROW_BLOCK
        V = torch.randn(mpad, n, device=dev, dtype=lrhs.dtype)
        V = V / V.norm(dim=1, keepdim=True)
        w = lrhs.reshape(n)
        rows = min(m, its // 2 + 1)
        rec["mgs_rows"] = rows
        rec["mgs_pass_ms"], _ = sync_ms(
            dev, lambda: linear._mgs_pass(V, w, rows), 20)
        hn = linear._norm2(w)
        rec["row_set_ms"], _ = sync_ms(
            dev, lambda: rk.row_set(V, rows, w, hn), 20)
        # the second-pass decision's own host copy of the two norms
        rec["norm_fetch_ms"], _ = sync_ms(
            dev, lambda: torch.stack([hn, hn]).cpu(), 20)
    rec["step_ms"], _ = sync_ms(dev, lambda: solver._step(
        cm, u, cfl, rtol, lmesh=lmesh, bl=bl), 3)
    print("phases", json.dumps(rec), flush=True)

    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    n0, r0 = bk.banded_apply.launches, rk.row_set.launches
    _sync(dev)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        solver._step(cm, u, cfl, rtol, lmesh=lmesh, bl=bl)
        _sync(dev)
    wall = time.perf_counter() - t0
    ka = sorted((e for e in prof.key_averages() if _on_device(e)),
                key=lambda e: -_device_us(e))
    print("trace", json.dumps(dict(
        case=case, pallas=pallas, traced_wall_ms=wall * 1e3,
        device_busy_ms=sum(_device_us(e) for e in ka) / 1e3,
        kernel_launches=bk.banded_apply.launches - n0,
        row_set_launches=rk.row_set.launches - r0,
        top_device_ms=[(e.key[:60], e.count, _device_us(e) / 1e3)
                       for e in ka[:15]])), flush=True)


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=sorted(MESHES), default="bench")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(dev), flush=True)
    for pallas in (True, False):
        profile(dev, MESHES[args.case], WARM_STEPS, pallas, args.case)


if __name__ == "__main__":
    main()
