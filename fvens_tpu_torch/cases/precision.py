"""Precision scheduling: an all-f32 phase down to an absolute residual
gate, then the f64 solve from there.

The twin of the JAX package's two forms, bench.py:run_solve(two_phase=)
and scripts/bench_bigmesh.py:_two_phase_solve:

  - phase A runs the whole solver in f32 (mesh, state, residual, Jacobian,
    Krylov solve and update, not just the Krylov inner loop) until the
    ABSOLUTE residual reaches the gate. In the cylinder form it is the
    whole SteadyFlowCase, starter then main, its main solve to tol 1e-16
    and tol_abs = gate; in the bench form one SteadyBackwardEuler with
    tol_abs = gate and no starter. Where phase A cannot reach the gate it
    runs to its maxiter and raises ToleranceError, as the JAX package's
    does;
  - phase B is one main-solve solver, reused from call to call (so a
    warm-up and a timed solve share it), whose configuration is the main
    solve's with cfl_init set to phase A's last accepted CFL
    (history[-1][3], or the main cfl_init where phase A took no step). It
    starts from phase A's state cast to f64 and runs to the case's target
    with its mixed-precision f32 Krylov solve.

Steps and Krylov iterations add up as the JAX package adds them: phase A's
main solve plus phase B; the starter is reported apart.

The JAX rationale (bench.py:175-178) is that f64 is emulated on a TPU. On
an H100 f64 is native, so whether this pays is for a benchmark to show.

    python -m fvens_tpu_torch.cases.precision [cylinder|bench]
        [--mesh NIxNJ] [--two-phase [GATE]] [--device cpu] [--no-warmup]
        [--max-steps N]

solves one case (the cylinder at 640x320 by default, banded; the bench
NACA0012 at 160x80 on its banded path) and prints its report as one JSON
line; --two-phase alone takes the gate 1e-3, as bench.py's does.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..solver.steady import SolveInfo

DEFAULT_GATE = 1e-3          # bench.py --two-phase's const


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class TwoPhaseInfo:
    """What one precision-scheduled solve did, phase by phase."""
    gate: float
    a: SolveInfo                   # phase A's main solve (f32)
    b: SolveInfo                   # phase B (f64 state, f32 Krylov)
    cfl_b: float                   # phase B's starting CFL
    wall_a: float                  # s, phase A (starter included)
    wall_b: float                  # s
    starter: SolveInfo | None = None    # phase A's starter (cylinder form)

    # the totals, as the JAX package adds them (the starter apart)
    @property
    def steps(self) -> int:
        return self.a.steps + self.b.steps

    @property
    def total_lin_iters(self) -> int:
        return self.a.total_lin_iters + self.b.total_lin_iters

    @property
    def device_lin_iters(self) -> int:
        return self.a.device_lin_iters + self.b.device_lin_iters

    @property
    def discarded_lin_iters(self) -> int:
        return self.a.discarded_lin_iters + self.b.discarded_lin_iters

    @property
    def capture_s(self) -> float:
        return self.a.capture_s + self.b.capture_s

    @property
    def converged(self) -> bool:
        return self.b.converged

    @property
    def initres(self) -> float:
        return self.b.initres

    @property
    def finalres(self) -> float:
        return self.b.finalres

    @property
    def walltime(self) -> float:
        """s, the two main solves' (the starter's apart)."""
        return self.a.walltime + self.b.walltime

    def report(self) -> dict:
        """The per-phase keys of a run_solve report."""
        st = self.starter
        return dict(
            two_phase=self.gate,
            phase_a=dict(
                starter_steps=st.steps if st else 0,
                starter_krylov_iters=st.total_lin_iters if st else 0,
                main_steps=self.a.steps,
                main_krylov_iters=self.a.total_lin_iters,
                abs_res=self.a.finalres, wall_s=self.wall_a,
                main_wall_s=self.a.walltime),
            phase_b=dict(cfl_init=self.cfl_b, steps=self.b.steps,
                         krylov_iters=self.b.total_lin_iters,
                         abs_res=self.b.finalres, wall_s=self.wall_b,
                         main_wall_s=self.b.walltime))


def two_phase(phase_a, solver_b, main_cfg, mesh, gate: float):
    """solve(u32, max_steps=None) -> (u, TwoPhaseInfo): phase_a(u32) ->
    (u_a, SolveInfo of its main solve) runs phase A from the f32 state u32;
    solver_b, a SteadyBackwardEuler, runs phase B on `mesh` (f64) from u_a
    cast up, with its cfg the main configuration `main_cfg` started at
    phase A's last CFL, stopping after `max_steps` steps where given
    (phase A always runs in full)."""
    def solve(u32, max_steps=None):
        dev = mesh.device
        _sync(dev)
        t0 = time.perf_counter()
        u_a, info_a = phase_a(u32)
        _sync(dev)
        t1 = time.perf_counter()
        # phase A's last accepted CFL, or the main solve's where it
        # accepted no step
        cfl_b = float(info_a.history[-1][3] if info_a.history
                      else main_cfg.cfl_init)
        solver_b.cfg = dataclasses.replace(main_cfg, cfl_init=cfl_b)
        u, info_b = solver_b.solve(mesh, u_a.to(mesh.dtype),
                                   max_steps=max_steps)
        _sync(dev)
        return u, TwoPhaseInfo(gate, info_a, info_b, cfl_b, t1 - t0,
                               time.perf_counter() - t1)
    return solve


def case_two_phase(case, mesh, gate: float):
    """The cylinder form (scripts/bench_bigmesh.py:_two_phase_solve) of the
    SteadyFlowCase `case` on its f64 `mesh`: solve(u32) with phase A the
    whole case in f32 to the gate and phase B its main solve."""
    from .casesolvers import SteadyFlowCase, build_space
    mesh32 = mesh.to(torch.float32)
    cfg = case.cfg
    case_a = SteadyFlowCase(dataclasses.replace(
        cfg, main=dataclasses.replace(cfg.main, tol=1e-16, tol_abs=gate)))
    solve = two_phase(lambda u32: case_a.solve(mesh32, u32),
                      case._make_solver(build_space(cfg), cfg.main),
                      cfg.main, mesh, gate)

    def run(u32, max_steps=None):
        u, info = solve(u32, max_steps)
        info.starter = case_a.starter_info
        return u, info
    return run


def solver_two_phase(solver, mesh, gate: float):
    """The bench form (bench.py:run_solve(two_phase=)) of the
    SteadyBackwardEuler `solver` on its f64 `mesh`: solve(u32) with phase
    A the same solver in f32 to the gate (tol 1e-16, cfl 500 -> 5000 and
    at most 600 steps, as bench.py builds it) and phase B a second
    solver like `solver`."""
    from ..config import PseudoTimeConfig
    from ..solver.steady import SteadyBackwardEuler
    pt = solver.cfg
    pt_a = PseudoTimeConfig(cfl_init=500.0, cfl_fin=5000.0, tol=1e-16,
                            tol_abs=float(gate), maxiter=600)
    solver_a = SteadyBackwardEuler(solver.space, pt_a, solver.lin, solver.nl)
    solver_b = SteadyBackwardEuler(solver.space, pt, solver.lin, solver.nl)
    mesh32 = mesh.to(torch.float32)
    return two_phase(lambda u32: solver_a.solve(mesh32, u32), solver_b, pt,
                     mesh, gate)


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description="one solve of the cylinder or "
                                             "the bench case, optionally "
                                             "precision-scheduled")
    ap.add_argument("case", nargs="?", default="cylinder",
                    choices=["cylinder", "bench"])
    ap.add_argument("--mesh", default=None,
                    help="NIxNJ (default 640x320 cylinder, 160x80 bench)")
    ap.add_argument("--two-phase", type=float, default=0.0, nargs="?",
                    const=DEFAULT_GATE, dest="two_phase",
                    help="precision scheduling: f32 phase down to this "
                         "ABSOLUTE residual, then f64 to the 1e-10 "
                         "absolute target (default gate 1e-3)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-warmup", action="store_true",
                    help="cylinder: one timed solve, no warm-up solve")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="bench: stop after this many steps (of phase B "
                         "where scheduled) and report without the "
                         "convergence verdict; the bench case does not "
                         "converge on its generated mesh")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        import sys
        print("fvens_tpu_torch: no CUDA device (torch.cuda.is_available() "
              "is false); pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1
    mesh = (tuple(int(x) for x in args.mesh.split("x")) if args.mesh
            else None)
    if args.case == "cylinder":
        from . import bigmesh_case
        _, rep = bigmesh_case.run_solve(
            args.device, mesh=mesh or bigmesh_case.BIGMESH,
            warmup=not args.no_warmup, two_phase=args.two_phase)
    else:
        from . import bench_case
        solve, cm = bench_case.run_solve(
            args.device, mesh=mesh or bench_case.BENCH_MESH,
            two_phase=args.two_phase)
        _sync(cm.device)
        t0 = time.perf_counter()
        _, info = solve(max_steps=args.max_steps)
        _sync(cm.device)
        rep = dict(case="bench", cells=cm.n_cells, wall_s=time.perf_counter()
                   - t0, converged=info.converged, steps=info.steps,
                   krylov_iters=info.total_lin_iters, abs_res=info.finalres)
        if isinstance(info, TwoPhaseInfo):
            rep.update(info.report())
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
