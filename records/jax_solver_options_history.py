"""The JAX package's runs of the cylinder case under its other solver
options, recorded.

    JAX_PLATFORMS=cpu python records/jax_solver_options_history.py [--out FILE]

Runs fvens_tpu's SteadyFlowCase on the gather form of the cylinder case
(records/jax_gather_history.py: the inviscid 2D cylinder at M 0.38, HLLC,
weighted least squares, LINEAR, slip wall + far field, on
cylinder_omesh(160, 80, stretch=1.15**(20/80)); a first-order starter,
CFL 50 -> 1000 to a relative residual of 1e-1, then the second-order main
solve, CFL 500 -> 5000, f32 Jacobian/Krylov inside the f64 residual,
FGMRES(90) at rtol 1e-2, to an absolute residual of 1e-10) with each of
the solver options of OPTIONS in its linear solver, on the CPU with x64:

  - ilu0 (the fixed-point block ILU0) in the starter and the main solve,
    to convergence, with the classic CGS2 GMRES (which 160x80 takes by
    itself) and with blocked GMRES (forced): the two part in the endgame,
    which bounds how closely another implementation's totals can be held;
  - bsgs-recycle (bsgs x6 with warm start and GCRO-DR recycling of 16
    directions) in the main solve, from the state of the bsgs x6 starter,
    classic GMRES, to convergence or the main solve's limit of 600 steps;
  - amg, bline, mf-jvp (the exact JVP matvec) and mf-fd (the reference's
    finite-difference matvec, in f64: under mixed precision the JAX
    package's FD shell fails, see OPTIONS), each for MAIN_STEPS main steps
    from the state of the bsgs x6 starter, classic GMRES.

Each option is a set of LinearSolverConfig fields over the gather case's
(bsgs x6); fvens_tpu_torch/cases/bigmesh_case.py has the same presets
(tests/test_torch_krylov_options.py holds them equal).

Writes records/jax_solver_options_history.json: the case's configuration,
the options, and per run the option, the starter's linear solver, the
GMRES path, the main steps' cap, and the starter's and the main solve's
accepted steps, Krylov iterations, first and final residual, recoveries
and per-step history (step, residual, CFL, Krylov iterations).
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import platform
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "records"))

import jax_bigmesh_history as banded_record  # noqa: E402

MESH = (160, 80)
MAIN_STEPS = 20                  # the main steps of the capped runs
BSGS = dict(banded=False, pc="bsgs", pc_sweeps=6)
OPTIONS = {
    "ilu0": dict(banded=False, pc="ilu0", pc_sweeps=3),
    "amg": dict(banded=False, pc="amg"),
    "bline": dict(banded=False, pc="bline", pc_sweeps=2),
    "mf-jvp": dict(BSGS, matrix_free=True),
    # in f64: the JAX package's FD shell under mixed precision returns f64
    # into the f32 GMRES loop, whose while_loop then refuses the carry
    # (TypeError: float64 residual in, float32 out)
    "mf-fd": dict(BSGS, matrix_free=True, matrix_free_fd=True,
                  mixed_precision=False),
    "bsgs-recycle": dict(BSGS, warm_start=True, deflation_k=16),
}
# (option, starter: "own" or "bsgs", main steps cap or None, blocked GMRES)
RUNS = (("amg", "bsgs", MAIN_STEPS, False),
        ("bline", "bsgs", MAIN_STEPS, False),
        ("mf-jvp", "bsgs", MAIN_STEPS, False),
        ("mf-fd", "bsgs", MAIN_STEPS, False),
        ("bsgs-recycle", "bsgs", None, False),
        ("ilu0", "own", None, False), ("ilu0", "own", None, True))


def case_config(lin: dict):
    """The gather case's FlowCaseConfig with the LinearSolverConfig fields
    `lin`."""
    cfg = banded_record.case_config()
    return dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, **lin))


def run(option: str, starter: str, cap, blocked: bool) -> dict:
    import jax.numpy as jnp

    import fvens_tpu.solver.linear as jlinear
    from fvens_tpu.cases.casesolvers import (SteadyFlowCase, build_space,
                                             initial_state)
    from fvens_tpu.mesh import compile_mesh
    from fvens_tpu.mesh.meshgen import cylinder_omesh
    from fvens_tpu.solver.steady import ToleranceError

    jlinear._BLOCKED_N_THRESHOLD = (0 if blocked else
                                    banded_record.BLOCKED_N_THRESHOLD)
    ni, nj = MESH
    cfg = case_config(OPTIONS[option])
    scfg = cfg if starter == "own" else case_config(BSGS)
    mesh = compile_mesh(cylinder_omesh(ni, nj, stretch=1.15 ** (20.0 / nj)),
                        cfg.bcs, dtype=jnp.float64)
    u = initial_state(build_space(cfg), mesh).astype(jnp.float64)
    t0 = time.perf_counter()
    solver = SteadyFlowCase(scfg)._make_solver(
        build_space(scfg, order2=False), scfg.init)
    log1, out1 = banded_record._History(), io.StringIO()
    with contextlib.redirect_stdout(out1):
        try:
            u, _ = solver.solve(mesh, u, logger=log1)
        except ToleranceError:
            pass
    main_cfg = (cfg.main if cap is None
                else dataclasses.replace(cfg.main, maxiter=cap))
    solver = SteadyFlowCase(cfg)._make_solver(build_space(cfg), main_cfg)
    log2, out2 = banded_record._History(), io.StringIO()
    converged = False
    with contextlib.redirect_stdout(out2):
        try:
            _, info = solver.solve(mesh, u, logger=log2)
            converged = bool(info.converged)
        except ToleranceError:
            pass
    wall = time.perf_counter() - t0
    return dict(option=option, lin=OPTIONS[option], starter=starter,
                main_cap=cap, mesh=f"cylinder_omesh({ni}, {nj})",
                cells=mesh.n_cells, n=4 * mesh.NC, blocked_gmres=blocked,
                converged=converged,
                starter_run=banded_record._summary(
                    log1.rows, out1.getvalue().splitlines()),
                main=banded_record._summary(
                    log2.rows, out2.getvalue().splitlines()),
                host_seconds=wall)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "records", "jax_solver_options_history.json"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    runs = []
    for option, starter, cap, blocked in RUNS:
        rec = run(option, starter, cap, blocked)
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("starter_run", "main")}),
              json.dumps({k: {kk: vv for kk, vv in rec[k].items()
                              if kk != "history"}
                          for k in ("starter_run", "main")}), flush=True)
        runs.append(rec)
    with open(args.out, "w") as f:
        json.dump(dict(
            case=dict(name="inviscid cylinder, scripts/bench_bigmesh.py "
                           "build_case(banded=False), --stop abs",
                      stretch="1.15 ** (20 / nj)",
                      config=dataclasses.asdict(case_config(BSGS))),
            options=OPTIONS, main_steps=MAIN_STEPS,
            host=dict(machine=platform.machine(), cpus=os.cpu_count(),
                      python=platform.python_version(),
                      jax=jax.__version__),
            runs=runs), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
