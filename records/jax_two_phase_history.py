"""The JAX package's precision-scheduled solves, recorded.

    JAX_PLATFORMS=cpu python records/jax_two_phase_history.py [--out FILE]

Runs the JAX package's two forms of precision scheduling on the CPU with
x64: phase A runs the whole solver in f32 down to an ABSOLUTE residual
gate of 1e-3, then phase B continues in f64 (f32 Krylov) from phase A's
last CFL.

  - "cylinder": scripts/bench_bigmesh.py:_two_phase_solve on
    build_case(160, 80, banded=True) with `--stop abs` (the inviscid
    cylinder at M 0.38, HLLC, weighted least squares, LINEAR; phase A the
    whole SteadyFlowCase, its first-order starter then its main solve;
    phase B to an absolute residual of 1e-10), then the same case solved
    single-phase (case.solve) for its entropy error. About 8 minutes on
    an 8-core x86-64 host: phase B wanders for hundreds of steps.
  - "cylinder_blocked": the same two-phase solve with GMRES forced onto
    its blocked path (a rounding-level change of the same arithmetic), for
    the spread of phase B; a ToleranceError is recorded as not converged,
    with the lowest residual phase B reached. About 8 minutes.
  - "bench": bench.py:run_solve(two_phase=1e-3) (laminar NACA0012 on
    naca0012_omesh(160, 80), the gather path, bsgs x6, phase A one
    SteadyBackwardEuler to the gate, no starter). This case converges in
    neither package (its second-order solve cycles near 1e-3), so phase A
    is recorded in full and phase B's first B_STEPS steps only: the run is
    stopped there. About 1 minute.

Each solve's per-step history (step, residual, CFL, Krylov iterations) is
taken by a logger handed to every SteadyBackwardEuler.solve the forms
call. Writes records/jax_two_phase_history.json: the agreement limits
another implementation is held to (LIMITS), and per form each phase's
history, steps and Krylov iterations, phase B's starting CFL, the totals
as the JAX package adds them (phase A's main solve plus phase B), the
final absolute residual and the entropy errors.
"""

import argparse
import contextlib
import io
import json
import os
import platform
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

MESH = (160, 80)
GATE = 1e-3
B_STEPS = 20
# How closely another implementation of these solves is held to them:
#   - cylinder: the starter's steps equal, its Krylov iterations per step
#     within agree_iters; the first agree_steps of phase A's main steps
#     step for step (Krylov iterations within agree_iters, residuals within
#     agree_res relative); phase A's main steps within a_steps (relative,
#     at least one step) and phase B's starting CFL within cfl_b
#     (relative) of this run's; phase B's lowest residual over its 600
#     steps at most b_min times the highest of the two JAX runs' lowest
#     (this run's, classic GMRES, converged at phase-B step 537; the
#     same solve with GMRES forced blocked, "cylinder_blocked", a
#     rounding-level change, did not converge in 600 steps and came no
#     lower than 2.1e-9); where it converged, the entropy error within
#     `entropy` (relative) of a single-phase solve's (each run stops at
#     its own state below the 1e-10 target, and the entropy error moves
#     with it: this run's two-phase and single-phase solves are 1.6e-9
#     apart, and on a finer mesh, with a smaller entropy error, two such
#     states part further; H100, 640x320: 4.4e-8);
#   - bench: phase A's first bench_agree_steps steps as above (from its
#     step 2 the f32 Krylov solve stops at its cap of 90 iterations
#     unconverged, and the trajectory is chaotic: a blowup and recovery in
#     phase A, another in phase B's first 20 steps), phase A reaching the
#     gate (within its 600 steps), phase B starting at phase A's last CFL,
#     its recorded steps finite.
# Phase A runs in f32 from its first step, so its trajectory parts from
# another implementation's at the f32 rounding level (on the 32x16
# cylinder by 3e-7 at the starter's first step, 7e-5 by phase A's second
# main step, 1-7% near the gate); the Krylov solves stop at rtol 1e-2,
# and a rounding-level change can move the iteration where one crosses it
# by one. Phase B on the cylinder wanders for hundreds of steps (537 here
# against the single-phase solve's 49) with blowups and recoveries, and
# whether it reaches 1e-10 within its 600 steps turns on rounding, so its
# steps are reported, not held.
LIMITS = dict(agree_steps=5, bench_agree_steps=2, agree_iters=1,
              agree_res=1e-4, a_steps=0.25, cfl_b=0.1, b_min=10.0,
              entropy=1e-6)


class _Stop(Exception):
    """Stops a solve the record needs no more of."""


class _Recorder:
    """Hands every SteadyBackwardEuler.solve a logger that keeps (step,
    residual, CFL, Krylov iterations); `stop_after` maps a call's index to
    the number of rows after which that solve is stopped."""

    def __init__(self, stop_after=None):
        self.calls = []
        self.stop_after = stop_after or {}

    def __enter__(self):
        from fvens_tpu.solver.steady import SteadyBackwardEuler
        self._cls, self._solve = SteadyBackwardEuler, SteadyBackwardEuler.solve
        rec = self

        def solve(solver, mesh, u0, log_every=0, logger=None):
            rows = []
            rec.calls.append(dict(dtype=str(u0.dtype), rows=rows))
            limit = rec.stop_after.get(len(rec.calls) - 1)

            class Log:
                def log(self, step, relres, absres, lin_iters=0, cfl=0.0,
                        **_):
                    rows.append([int(step), float(absres), float(cfl),
                                 int(lin_iters)])
                    if limit is not None and len(rows) >= limit:
                        raise _Stop
            return rec._solve(solver, mesh, u0, log_every=log_every,
                              logger=Log())
        SteadyBackwardEuler.solve = solve
        return self

    def __exit__(self, *exc):
        self._cls.solve = self._solve
        return False


def _phase(rows):
    return dict(steps=len(rows), krylov_iters=sum(r[3] for r in rows),
                first_res=rows[0][1] if rows else None,
                final_res=rows[-1][1] if rows else None, history=rows)


def run_cylinder(blocked: bool = False) -> dict:
    import jax
    import bench_bigmesh
    import fvens_tpu.solver.linear as jlinear
    from fvens_tpu.cases.casesolvers import build_space
    from fvens_tpu.output import entropy_error
    from fvens_tpu.solver.steady import ToleranceError

    case, mesh, u0 = bench_bigmesh.build_case(*MESH, platform="cpu",
                                              banded=True, tol=1e-16)
    jax.config.update("jax_enable_compilation_cache", False)
    solve = bench_bigmesh._two_phase_solve(case, mesh, u0, GATE, 1e-16, 0)
    out = io.StringIO()
    keep = jlinear._BLOCKED_N_THRESHOLD
    if blocked:
        jlinear._BLOCKED_N_THRESHOLD = 0
    t0 = time.perf_counter()
    try:
        with _Recorder() as rec, contextlib.redirect_stdout(out):
            u, info = solve()
    except ToleranceError:
        u = info = None
    finally:
        jlinear._BLOCKED_N_THRESHOLD = keep
    wall = time.perf_counter() - t0
    starter_a, main_a, main_b = (c["rows"] for c in rec.calls)
    assert [c["dtype"] for c in rec.calls] == ["float32", "float32",
                                              "float64"]
    space = build_space(case.cfg)
    if blocked:
        # the same solve on the other GMRES path: its phase B's spread
        return dict(
            form="scripts/bench_bigmesh.py:_two_phase_solve, gmres blocked",
            mesh=f"cylinder_omesh{MESH}", cells=mesh.n_cells, gate=GATE,
            phase_a=dict(starter=_phase(starter_a), main=_phase(main_a)),
            phase_b=dict(cfl_init=main_b[0][2], **_phase(main_b)),
            converged=info is not None and bool(info.converged),
            final_abs_res=main_b[-1][1],
            min_abs_res=min(r[1] for r in main_b),
            entropy=(None if info is None
                     else float(entropy_error(space, mesh, u))),
            recoveries=out.getvalue().count("retrying from"),
            host_seconds=wall)
    t0 = time.perf_counter()
    with _Recorder() as rec1, contextlib.redirect_stdout(io.StringIO()):
        u1, info1 = case.solve(mesh, u0)
    wall1 = time.perf_counter() - t0
    return dict(
        form="scripts/bench_bigmesh.py:_two_phase_solve",
        mesh=f"cylinder_omesh{MESH}", cells=mesh.n_cells, gate=GATE,
        phase_a=dict(starter=_phase(starter_a), main=_phase(main_a)),
        phase_b=dict(cfl_init=main_b[0][2], **_phase(main_b)),
        steps=info.steps, krylov_iters=info.total_lin_iters,
        converged=bool(info.converged), final_abs_res=float(info.finalres),
        entropy=float(entropy_error(space, mesh, u)),
        recoveries=out.getvalue().count("retrying from"),
        host_seconds=wall,
        single_phase=dict(
            starter=_phase(rec1.calls[0]["rows"]),
            main=_phase(rec1.calls[1]["rows"]),
            converged=bool(info1.converged),
            final_abs_res=float(info1.finalres),
            entropy=float(entropy_error(space, mesh, u1)),
            host_seconds=wall1))


def run_bench() -> dict:
    import jax
    import bench

    solve, mesh = bench.run_solve(platform="cpu", two_phase=GATE)
    jax.config.update("jax_enable_compilation_cache", False)
    out = io.StringIO()
    t0 = time.perf_counter()
    with _Recorder(stop_after={1: B_STEPS}) as rec, \
            contextlib.redirect_stdout(out):
        try:
            solve()
            raise AssertionError("phase B was to be stopped")
        except _Stop:
            pass
    wall = time.perf_counter() - t0
    main_a, main_b = (c["rows"] for c in rec.calls)
    assert [c["dtype"] for c in rec.calls] == ["float32", "float64"]
    return dict(
        form="bench.py:run_solve(two_phase=)", path="gather",
        mesh="naca0012_omesh(160, 80)", cells=mesh.n_cells, gate=GATE,
        phase_a=dict(main=_phase(main_a)),
        phase_b=dict(cfl_init=main_b[0][2], recorded_steps=B_STEPS,
                     history=main_b),
        recoveries=out.getvalue().count("retrying from"),
        host_seconds=wall)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "records", "jax_two_phase_history.json"))
    ap.add_argument("--only", default="",
                    help="comma-separated forms to run, merged into --out")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    forms = {"cylinder": run_cylinder, "bench": run_bench,
             "cylinder_blocked": lambda: run_cylinder(blocked=True)}
    runs = {}
    for name in (args.only.split(",") if args.only else forms):
        fn = forms[name]
        runs[name] = fn()
        print(name, json.dumps({k: v for k, v in runs[name].items()
                                if k not in ("phase_a", "phase_b",
                                             "single_phase")}),
              flush=True)
    if args.only and os.path.exists(args.out):
        with open(args.out) as f:
            runs = dict(json.load(f)["runs"], **runs)
    with open(args.out, "w") as f:
        json.dump(dict(gate=GATE, limits=LIMITS,
                       host=dict(machine=platform.machine(),
                                 cpus=os.cpu_count(),
                                 python=platform.python_version(),
                                 jax=jax.__version__),
                       runs=runs), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
