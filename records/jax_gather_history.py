"""The JAX package's runs of the cylinder case on the gather path, recorded.

    JAX_PLATFORMS=cpu python records/jax_gather_history.py [--out FILE]

Runs fvens_tpu's SteadyFlowCase on the case that
`scripts/bench_bigmesh.py --stop abs` builds without `--banded` (its
build_case with banded=False) and that the PyTorch port's
`fvens_tpu_torch/cases/bigmesh_case.py` drives with banded=False: the
inviscid 2D cylinder at M 0.38 (HLLC, weighted least squares, LINEAR, slip
wall + far field) on cylinder_omesh(ni, nj, stretch=1.15**(20/nj)); a
first-order starter (CFL 50 -> 1000 to a relative residual of 1e-1, at most
200 steps), then the second-order main solve (CFL 500 -> 5000, f32
Jacobian/Krylov inside the f64 residual, FGMRES(90) at rtol 1e-2) to an
absolute residual of 1e-10, at most 600 steps, with the slot-gather
operators (make_bsr_matvec, make_preconditioner). On the CPU with x64, six
runs:

  - bsgs x6 (slot-gather block-Jacobi sweeps, the preconditioner of
    scripts/bench_bigmesh.py) at cylinder_omesh(32, 16) with blocked GMRES,
    and at cylinder_omesh(160, 80) with blocked GMRES and with the classic
    CGS2 GMRES, which that size takes by itself;
  - bcsgs x3 (multicolor block SGS, LinearSolverConfig's default) at
    cylinder_omesh(32, 16) and (160, 80) with the classic GMRES, and at
    (160, 80) with blocked GMRES: the two 160x80 runs agree step for step
    until the Krylov solves start to stop at 90 iterations, and then part,
    which bounds how closely another implementation's endgame can be held
    to either.

Blocked GMRES is forced by lowering fvens_tpu.solver.linear.
_BLOCKED_N_THRESHOLD to 0, so the path that runs by itself from 65,536
cells runs at these sizes too.

The full 640x320 mesh takes hours on the CPU and is not recorded.

Writes records/jax_gather_history.json: the case's configuration per
preconditioner, and per run the mesh, the preconditioner, the GMRES path,
the starter's and the main solve's accepted steps, Krylov iterations, first
and final residual, recoveries and per-step history (step, residual, CFL,
Krylov iterations), and the converged state's entropy error.
"""

import argparse
import dataclasses
import json
import os
import platform
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "records"))

import jax_bigmesh_history as banded_record  # noqa: E402

PCS = {"bsgs": 6, "bcsgs": 3}       # pc: pc_sweeps
RUNS = (((32, 16), "bsgs", True), ((160, 80), "bsgs", True),
        ((160, 80), "bsgs", False), ((32, 16), "bcsgs", False),
        ((160, 80), "bcsgs", False), ((160, 80), "bcsgs", True))


def case_config(pc: str):
    """The FlowCaseConfig of scripts/bench_bigmesh.py:build_case with
    banded=False and --stop abs, preconditioned by `pc` with PCS[pc]
    sweeps."""
    cfg = banded_record.case_config()
    return dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, banded=False, pc=pc, pc_sweeps=PCS[pc]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "records",
                                                  "jax_gather_history.json"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    runs = []
    for (ni, nj), pc, blocked in RUNS:
        rec = dict(pc=pc, pc_sweeps=PCS[pc],
                   **banded_record.run(case_config(pc), ni, nj, blocked))
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("starter", "main")}),
              json.dumps({k: {kk: vv for kk, vv in rec[k].items()
                              if kk != "history"}
                          for k in ("starter", "main")}), flush=True)
        runs.append(rec)
    with open(args.out, "w") as f:
        json.dump(dict(
            case=dict(name="inviscid cylinder, scripts/bench_bigmesh.py "
                           "build_case(banded=False), --stop abs",
                      stretch="1.15 ** (20 / nj)",
                      config={pc: dataclasses.asdict(case_config(pc))
                              for pc in PCS}),
            host=dict(machine=platform.machine(), cpus=os.cpu_count(),
                      python=platform.python_version(),
                      jax=jax.__version__),
            runs=runs), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
