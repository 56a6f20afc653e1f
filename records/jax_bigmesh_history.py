"""The JAX package's own runs of the large-mesh cylinder case, recorded.

    JAX_PLATFORMS=cpu python records/jax_bigmesh_history.py [--out FILE]

Runs fvens_tpu's SteadyFlowCase on the case that
`scripts/bench_bigmesh.py --banded --stop abs` builds (its build_case) and
that the PyTorch port's `fvens_tpu_torch/cases/bigmesh_case.py` drives: the
inviscid 2D cylinder at M 0.38 (HLLC, weighted least squares, LINEAR, slip
wall + far field) on cylinder_omesh(ni, nj, stretch=1.15**(20/nj)); a
first-order starter (CFL 50 -> 1000 to a relative residual of 1e-1, at most
200 steps), then the second-order main solve (CFL 500 -> 5000, f32
Jacobian/Krylov inside the f64 residual, banded FGMRES(90) at rtol 1e-2 with
bsgs x6) to an absolute residual of 1e-10, at most 600 steps. On the CPU
with x64 and the XLA banded operators, three runs:

  - cylinder_omesh(32, 16), 512 cells, blocked GMRES;
  - cylinder_omesh(160, 80), 12,800 cells, blocked GMRES;
  - cylinder_omesh(160, 80) again with the classic CGS2 GMRES, which this
    size takes by itself: the two runs at 160x80 agree step for step until
    the residual nears 1e-7 and then part, which bounds how closely another
    implementation's endgame can be held to either.

Blocked GMRES is forced by lowering fvens_tpu.solver.linear.
_BLOCKED_N_THRESHOLD to 0, so the path that runs by itself from 65,536
cells runs at these sizes too.

The full 640x320 mesh takes hours on the CPU and is not recorded.

Writes records/jax_bigmesh_history.json: the case's configuration, and per
run the mesh, the GMRES path, the starter's and the main solve's accepted steps, Krylov iterations,
first and final residual, recoveries and per-step history (step, residual,
CFL, Krylov iterations), and the converged state's entropy error.
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

RUNS = (((32, 16), True), ((160, 80), True), ((160, 80), False))
BLOCKED_N_THRESHOLD = 262_144      # the JAX package's own threshold
TOL_ABS = 1e-10


class _History:
    def __init__(self):
        self.rows = []

    def log(self, step, relres, absres, lin_iters=0, cfl=0.0, **_):
        self.rows.append((step, absres, cfl, lin_iters))


def case_config():
    """The FlowCaseConfig of scripts/bench_bigmesh.py:build_case with
    banded=True and --stop abs (tol 1e-16, tol_abs 1e-10)."""
    from fvens_tpu.config import (BCSpec, FlowCaseConfig, LinearSolverConfig,
                                  NonlinearUpdateConfig, NumericsConfig,
                                  PhysicsConfig, PseudoTimeConfig)
    bcs = [BCSpec(marker=2, type="slipwall"),
           BCSpec(marker=4, type="farfield")]
    return FlowCaseConfig(
        physics=PhysicsConfig(Minf=0.38, Tinf=288.15, viscous=False),
        numerics=NumericsConfig(flux="HLLC", gradient="LEASTSQUARES",
                                reconstruction="LINEAR", order2=True),
        bcs=bcs,
        main=PseudoTimeConfig(cfl_init=500.0, cfl_fin=5000.0, tol=1e-16,
                              tol_abs=TOL_ABS, maxiter=600),
        init=PseudoTimeConfig(cfl_init=50.0, cfl_fin=1000.0, tol=1e-1,
                              maxiter=200),
        linear=LinearSolverConfig(restart=90, maxiter=90, rtol=1e-2,
                                  pc="bsgs", pc_sweeps=6,
                                  mixed_precision=True, banded=True),
        nl_update=NonlinearUpdateConfig("full"))


def _summary(rows, lines):
    res = [r[1] for r in rows]
    return dict(steps=len(rows), krylov_iters=sum(r[3] for r in rows),
                first_res=res[0], final_res=res[-1],
                recoveries=sum("retrying from" in ln for ln in lines),
                history=[[s, r, c, i] for s, r, c, i in rows])


def run(cfg, ni: int, nj: int, blocked: bool) -> dict:
    """The starter and main solves of SteadyFlowCase.solve, each logged,
    with blocked GMRES forced or the classic path."""
    import jax.numpy as jnp

    import fvens_tpu.solver.linear as jlinear
    from fvens_tpu.cases.casesolvers import (SteadyFlowCase, build_space,
                                             initial_state)
    from fvens_tpu.mesh import compile_mesh
    from fvens_tpu.mesh.meshgen import cylinder_omesh
    from fvens_tpu.output import entropy_error
    from fvens_tpu.solver.steady import ToleranceError

    jlinear._BLOCKED_N_THRESHOLD = 0 if blocked else BLOCKED_N_THRESHOLD
    mesh = compile_mesh(cylinder_omesh(ni, nj, stretch=1.15 ** (20.0 / nj)),
                        cfg.bcs, dtype=jnp.float64)
    case = SteadyFlowCase(cfg)
    u = initial_state(build_space(cfg), mesh).astype(jnp.float64)
    t0 = time.perf_counter()
    # SteadyFlowCase.execute_starter, with a logger
    starter = case._make_solver(build_space(cfg, order2=False), cfg.init)
    log1, out1 = _History(), io.StringIO()
    with contextlib.redirect_stdout(out1):
        try:
            u, _ = starter.solve(mesh, u, logger=log1)
        except ToleranceError:
            pass
    log2, out2 = _History(), io.StringIO()
    with contextlib.redirect_stdout(out2):
        u, info = case.execute_main(mesh, u, logger=log2)
    wall = time.perf_counter() - t0
    main = _summary(log2.rows, out2.getvalue().splitlines())
    assert blocked == (4 * mesh.NC >= jlinear._BLOCKED_N_THRESHOLD)
    return dict(mesh=f"cylinder_omesh({ni}, {nj})", cells=mesh.n_cells,
                n=4 * mesh.NC, blocked_gmres=blocked,
                converged=bool(info.converged),
                starter=_summary(log1.rows, out1.getvalue().splitlines()),
                main=main, entropy=entropy_error(build_space(cfg), mesh, u),
                host_seconds=wall)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "records",
                                                  "jax_bigmesh_history.json"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    cfg = case_config()
    runs = []
    for (ni, nj), blocked in RUNS:
        rec = run(cfg, ni, nj, blocked)
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("starter", "main")}),
              json.dumps({k: {kk: vv for kk, vv in rec[k].items()
                              if kk != "history"}
                          for k in ("starter", "main")}), flush=True)
        runs.append(rec)
    with open(args.out, "w") as f:
        json.dump(dict(
            case=dict(name="inviscid cylinder, scripts/bench_bigmesh.py "
                           "build_case(banded=True), --stop abs",
                      stretch="1.15 ** (20 / nj)",
                      config=dataclasses.asdict(cfg)),
            host=dict(machine=platform.machine(), cpus=os.cpu_count(),
                      python=platform.python_version(),
                      jax=jax.__version__),
            runs=runs), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
