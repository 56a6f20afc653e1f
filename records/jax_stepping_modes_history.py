"""The JAX package's runs of the large-mesh cylinder case under its
device-resident stepping options, recorded.

    JAX_PLATFORMS=cpu python records/jax_stepping_modes_history.py [--out F]

The case of records/jax_bigmesh_history.py (scripts/bench_bigmesh.py's
build_case with --banded --stop abs: the inviscid cylinder, a first-order
starter, then the second-order main solve to an absolute residual of
1e-10, f32 Krylov inside the f64 residual, banded FGMRES(90) at rtol 1e-2,
bsgs x6) on cylinder_omesh(160, 80), where GMRES takes its classic path by
itself, on the CPU with x64, with the PseudoTimeConfig options set on the
starter and the main solve alike (as build_case sets pipeline):

  - device_steps = 8: chunks of 8 steps inside one program (lax.scan over
    lax.cond), the controller on the device;
  - bake_mesh = True: the mesh closed over the step program.

Pipelined runs are not recorded: their step program and controller are the
single step's, and the JAX package's tests/test_solvers.py holds them to
it step for step, so they are the classic 160x80 run of
records/jax_bigmesh_history.json.

The JAX package logs no Krylov iterations for the steps of a chunk; each
solve's total comes from its SolveInfo (the starter's solve returns it when
it converges, as it does here).

Writes records/jax_stepping_modes_history.json: the case, and per run the
option, the starter's and the main solve's steps, Krylov iterations, first
and final residual, recoveries and per-step (step, residual, CFL, Krylov
iterations or 0) history, and the entropy error of the converged state.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from jax_bigmesh_history import _History, case_config  # noqa: E402

MESH = (160, 80)
OPTIONS = (("device_steps", 8), ("bake_mesh", True))


def _summary(rows, lines, total):
    res = [r[1] for r in rows]
    return dict(steps=len(rows), krylov_iters=total, first_res=res[0],
                final_res=res[-1],
                recoveries=sum("retrying from" in ln for ln in lines),
                history=[[s, r, c, i] for s, r, c, i in rows])


def run(option: str, value) -> dict:
    import jax.numpy as jnp

    from fvens_tpu.cases.casesolvers import (SteadyFlowCase, build_space,
                                             initial_state)
    from fvens_tpu.mesh import compile_mesh
    from fvens_tpu.mesh.meshgen import cylinder_omesh
    from fvens_tpu.output import entropy_error

    cfg = case_config()
    cfg = dataclasses.replace(
        cfg, main=dataclasses.replace(cfg.main, **{option: value}),
        init=dataclasses.replace(cfg.init, **{option: value}))
    ni, nj = MESH
    mesh = compile_mesh(cylinder_omesh(ni, nj, stretch=1.15 ** (20.0 / nj)),
                        cfg.bcs, dtype=jnp.float64)
    case = SteadyFlowCase(cfg)
    u = initial_state(build_space(cfg), mesh).astype(jnp.float64)
    t0 = time.perf_counter()
    starter = case._make_solver(build_space(cfg, order2=False), cfg.init)
    log1, out1 = _History(), io.StringIO()
    with contextlib.redirect_stdout(out1):
        u, info1 = starter.solve(mesh, u, logger=log1)
    log2, out2 = _History(), io.StringIO()
    with contextlib.redirect_stdout(out2):
        u, info = case.execute_main(mesh, u, logger=log2)
    wall = time.perf_counter() - t0
    return dict(option=option, value=value, mesh=f"cylinder_omesh{MESH}",
                cells=mesh.n_cells, n=4 * mesh.NC, blocked_gmres=False,
                converged=bool(info.converged),
                starter=_summary(log1.rows, out1.getvalue().splitlines(),
                                 info1.total_lin_iters),
                main=_summary(log2.rows, out2.getvalue().splitlines(),
                              info.total_lin_iters),
                entropy=entropy_error(build_space(cfg), mesh, u),
                host_seconds=wall)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "records", "jax_stepping_modes_history.json"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    runs = []
    for option, value in OPTIONS:
        rec = run(option, value)
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("starter", "main")}),
              json.dumps({k: {kk: vv for kk, vv in rec[k].items()
                              if kk != "history"}
                          for k in ("starter", "main")}), flush=True)
        runs.append(rec)
    with open(args.out, "w") as f:
        json.dump(dict(
            case=dict(name="inviscid cylinder, scripts/bench_bigmesh.py "
                           "build_case(banded=True), --stop abs, with each "
                           "option on the starter and the main solve",
                      stretch="1.15 ** (20 / nj)",
                      config=dataclasses.asdict(case_config())),
            host=dict(machine=platform.machine(), cpus=os.cpu_count(),
                      python=platform.python_version(),
                      jax=jax.__version__),
            runs=runs), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
