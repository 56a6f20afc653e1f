"""The JAX package's domain-decomposed runs of the cylinder case, recorded.

    JAX_PLATFORMS=cpu python records/jax_dist_history.py [--out FILE]

Runs fvens_tpu's DistributedFlowCase on the banded cylinder case of
records/jax_bigmesh_history.py (the inviscid 2D cylinder at M 0.38, HLLC,
weighted least squares, LINEAR, slip wall + far field, on
cylinder_omesh(160, 80, stretch=1.15**(20/80)); a first-order starter, CFL
50 -> 1000 to a relative residual of 1e-1, then the second-order main
solve, CFL 500 -> 5000, f32 Jacobian/Krylov inside the f64 residual,
FGMRES(90) at rtol 1e-2 with bsgs x6, banded, to an absolute residual of
1e-10), split into D = 2 and 4 parts on D of 8 virtual CPU devices, with
x64, under two partitions:

  - "bfs", partition_mesh's own (BFS growth + refinement, what
    DistributedFlowCase takes): on this O-mesh it cuts annuli, whose
    part-local preconditioner sends many Krylov solves to their cap of 90
    iterations; the main solve then wanders between 1e-6 and 1e-9 for
    hundreds of steps (346 and 423 at D = 2, 4; 320 and 450 with the
    Krylov solve in f64, so precision is not the cause);
  - "blocks", contiguous index blocks (the reference's trivial
    partitioner, meshpartitioning.cpp:354), given as partition_mesh's
    `part`: angular sectors of the O-mesh, which converge in fewer steps.

A distributed GMRES always runs the classic path. The steps are
DistributedFlowCase.solve's and run_output's (partition, the starter, the
main solve, gather, the functionals on the gathered state), taken one by
one so that each solve is logged.

Writes records/jax_dist_history.json: the case's configuration, the
agreement limits another implementation is held to (LIMITS), and per run
D, the partition and its halo statistics, the starter's and the main solve's
accepted steps, Krylov iterations, first and final residual, recoveries
and per-step history (step, residual, CFL, Krylov iterations), and the
functionals of the converged state.
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

XLA = "--xla_force_host_platform_device_count=8"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + XLA).strip()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "records"))

import jax_bigmesh_history as banded_record  # noqa: E402

MESH = (160, 80)
PARTS = (2, 4)
PARTITIONS = ("bfs", "blocks")
# How closely another implementation of the same distributed solve is held
# to these runs: the starter's steps equal; the first agree_steps main
# steps step for step (Krylov iterations within agree_iters, residuals
# within agree_res of each other, relative); converged, in at most
# (1 + main_steps) times these runs' main steps and (1 + krylov_iters)
# times their Krylov iterations, and in at least the bound from below
# stated next; the converged entropy, CDp and CDsf within
# functionals (relative), CL (zero by symmetry: its converged value is
# noise, a few 1e-10 to 1e-9 in these runs) within cl_abs absolute.
# Near the f32 floor the Krylov solves reach their cap of 90 iterations and
# the endgame wanders, so a run that meets the tolerance a step earlier
# ends many steps sooner than these runs (the contiguous-block D = 2 run
# came to 2.1e-10 at main step 52 and wandered to step 142). So the totals
# are held from below against the steps and Krylov iterations these runs
# took to first come within near_tol times the tolerance (1e-9): a run of
# the same solve cannot reach the tolerance before its residual has fallen
# that far, so one that stops sooner than (1 - main_steps) and
# (1 - krylov_iters) times those has stopped on a wrong norm.
LIMITS = dict(agree_steps=20, agree_iters=1, agree_res=0.01, main_steps=0.25,
              krylov_iters=0.35, near_tol=10.0, functionals=1e-8,
              cl_abs=5e-9)


def blocks(n: int, D: int):
    """Contiguous index blocks: cell c in part c * D // n."""
    import numpy as np
    return np.minimum(np.arange(n) * D // n, D - 1)


def run(cfg, D: int, partition: str) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fvens_tpu.cases.casesolvers import build_space
    from fvens_tpu.dist import ShardedFlow, halo_schedule_stats
    from fvens_tpu.dist import partition_mesh
    from fvens_tpu.mesh import compile_mesh
    from fvens_tpu.mesh.meshgen import cylinder_omesh
    from fvens_tpu.output import entropy_error, surface_data
    from fvens_tpu.solver.steady import ToleranceError

    ni, nj = MESH
    md = cylinder_omesh(ni, nj, stretch=1.15 ** (20.0 / nj))
    devices = jax.devices()[:D]
    t0 = time.perf_counter()
    bundle = partition_mesh(md, cfg.bcs, D, part=(
        blocks(md.nelem, D) if partition == "blocks" else None))
    sf_main = ShardedFlow(space=build_space(cfg), bundle=bundle,
                          devices=devices)
    sf1 = ShardedFlow(space=build_space(cfg, order2=False), bundle=bundle,
                      devices=devices)
    log1, out1 = banded_record._History(), io.StringIO()
    u = sf_main.initial_state()
    with contextlib.redirect_stdout(out1):
        try:
            u, _ = sf1.solve_implicit(cfg.init, lin=cfg.linear,
                                      nl=cfg.nl_update, u=u, logger=log1)
        except ToleranceError:
            pass
    log2, out2 = banded_record._History(), io.StringIO()
    converged = False
    with contextlib.redirect_stdout(out2):
        try:
            u, info = sf_main.solve_implicit(cfg.main, lin=cfg.linear,
                                             nl=cfg.nl_update, u=u,
                                             logger=log2)
            converged = bool(info.converged)
        except ToleranceError:
            pass
    wall = time.perf_counter() - t0
    ug = sf_main.gather_solution(np.asarray(u))
    mesh = compile_mesh(md, cfg.bcs)
    space = build_space(cfg)
    upad = np.tile(np.asarray(space.uinf), (mesh.NC, 1))
    upad[:mesh.n_cells] = ug
    uj = jnp.asarray(upad)
    _, (CL, CDp, CDsf) = surface_data(space, mesh, uj, [2])
    return dict(parts=D, partition=partition,
                mesh=f"cylinder_omesh({ni}, {nj})",
                cells=mesh.n_cells, halo=halo_schedule_stats(bundle),
                converged=converged,
                starter=banded_record._summary(
                    log1.rows, out1.getvalue().splitlines()),
                main=banded_record._summary(
                    log2.rows, out2.getvalue().splitlines()),
                functionals=dict(entropy=float(entropy_error(space, mesh,
                                                             uj)),
                                 CL=float(CL), CDp=float(CDp),
                                 CDsf=float(CDsf)),
                host_seconds=wall)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "records", "jax_dist_history.json"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    cfg = banded_record.case_config()
    runs = []
    for partition in PARTITIONS:
        for D in PARTS:
            rec = run(cfg, D, partition)
            print(json.dumps({k: v for k, v in rec.items()
                              if k not in ("starter", "main")}),
                  json.dumps({k: {kk: vv for kk, vv in rec[k].items()
                                  if kk != "history"}
                              for k in ("starter", "main")}), flush=True)
            runs.append(rec)
    with open(args.out, "w") as f:
        json.dump(dict(
            case=dict(name="inviscid cylinder, scripts/bench_bigmesh.py "
                           "build_case(banded=True), --stop abs, "
                           "DistributedFlowCase",
                      stretch="1.15 ** (20 / nj)", wall_markers=[2],
                      config=dataclasses.asdict(cfg)),
            limits=LIMITS,
            host=dict(machine=platform.machine(), cpus=os.cpu_count(),
                      python=platform.python_version(),
                      jax=jax.__version__),
            runs=runs), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
