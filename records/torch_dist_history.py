"""The port's domain-decomposed runs of the cylinder case, held against the
JAX package's record of the same runs.

    python records/torch_dist_history.py [--device cpu] [--out FILE]

Runs fvens_tpu_torch's DistributedFlowCase on the case of
records/jax_dist_history.py (the banded cylinder case of
cases/bigmesh_case.py, wall marker 2, on cylinder_omesh(160, 80,
stretch=1.15**(20/80)), starter then the main solve to an absolute
residual of 1e-10) over D ranks, for each run of that record (D = 2 and
4; "blocks", contiguous index blocks, cell c in part c * D // n, first,
then "bfs", partition_mesh's own), on the card (`--device cuda`, the
default: one NCCL rank per card, so D ranks need D cards) or on the CPU
(`--device cpu`: gloo ranks, one torch thread each). Each run is compared
with the record's run of the same D and partition:

  - the starter's and the main solve's steps and Krylov iterations, the
    functionals of the converged state;
  - where the two main trajectories part: the first main step whose
    residual differs from the record's by more than 1e-6, 1e-4 and 1e-2
    (relative), and the first whose Krylov iterations differ by more than
    the record's agree_iters;
  - the record's limits (its LIMITS): the first agree_steps steps, the
    totals from above, and from below (the steps and Krylov iterations the
    record's run took to come within near_tol times the tolerance).

Writes records/torch_dist_history.json (after each run, so a cut run keeps
what finished): the device, and per run these comparisons beside the
port's histories.
"""

import argparse
import dataclasses
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RECORD = os.path.join(ROOT, "records", "jax_dist_history.json")
MESH = (160, 80)
WALL = (2,)
PART_AT = (1e-6, 1e-4, 1e-2)     # relative residual gaps located
TIMEOUT = 600.0                  # a world's process-group timeout, s


def rank_run(comm, partition: str) -> dict:
    """One rank of the run: DistributedFlowCase.rank_run_output; rank 0
    returns the histories and functionals."""
    from fvens_tpu_torch.cases.bigmesh_case import case_config
    from fvens_tpu_torch.cases.casesolvers import DistributedFlowCase
    from fvens_tpu_torch.mesh.meshgen import cylinder_omesh
    cfg = dataclasses.replace(case_config(), wall_markers=WALL)
    md = cylinder_omesh(*MESH, stretch=1.15 ** (20.0 / MESH[1]))
    n, D = md.nelem, comm.size
    part = (np.minimum(np.arange(n) * D // n, D - 1)
            if partition == "blocks" else None)
    case = DistributedFlowCase(cfg, D)
    t0 = time.perf_counter()
    _, info, fnls = case.rank_run_output(comm, md, part=part)
    wall = time.perf_counter() - t0
    if comm.rank != 0:
        return {}
    st = case.starter_info
    return dict(wall_s=wall, converged=bool(info.converged),
                starter=dict(steps=st.steps, krylov_iters=st.total_lin_iters,
                             history=[list(h) for h in st.history]),
                main=dict(steps=info.steps, krylov_iters=info.total_lin_iters,
                          history=[list(h) for h in info.history]),
                functionals=dict(entropy=float(fnls.entropy),
                                 CL=float(fnls.CL), CDp=float(fnls.CDp),
                                 CDsf=float(fnls.CDsf)))


def first_within(hist, level: float):
    """(step, Krylov iterations to it) at which a record history (step,
    residual, CFL, iterations) first comes within `level`; None if never."""
    its = 0
    for step, res, _, it in hist:
        its += it
        if res <= level:
            return step, its
    return None


def compare(got: dict, want: dict, lim: dict, tol_abs: float) -> dict:
    """The port's run against the record's run of the same D and
    partition."""
    h, w = got["main"]["history"], want["main"]["history"]
    pairs = list(zip(h, w))
    part_at = {}
    for tol in PART_AT:
        part_at[f"{tol:g}"] = next((a[0] for a, b in pairs
                                    if abs(a[2] - b[1]) > tol * b[1]), None)
    iters_part_at = next((a[0] for a, b in pairs
                          if abs(a[4] - b[3]) > lim["agree_iters"]), None)
    agree = all(abs(a[4] - b[3]) <= lim["agree_iters"]
                and abs(a[2] - b[1]) <= lim["agree_res"] * b[1]
                for a, b in pairs[:lim["agree_steps"]])
    wm, gm = want["main"], got["main"]
    floor = first_within(w, lim["near_tol"] * tol_abs)
    above = (gm["steps"] <= (1 + lim["main_steps"]) * wm["steps"]
             and gm["krylov_iters"]
             <= (1 + lim["krylov_iters"]) * wm["krylov_iters"])
    below = floor is not None and (
        gm["steps"] >= (1 - lim["main_steps"]) * floor[0]
        and gm["krylov_iters"] >= (1 - lim["krylov_iters"]) * floor[1])
    gf, wf = got["functionals"], want["functionals"]
    fn_err = {k: abs(gf[k] - wf[k]) / (1.0 if k == "CL" else abs(wf[k]))
              for k in wf}
    fn_ok = all(v <= (lim["cl_abs"] if k == "CL" else lim["functionals"])
                for k, v in fn_err.items())
    return dict(
        starter_steps=[got["starter"]["steps"], want["starter"]["steps"]],
        main_steps=[gm["steps"], wm["steps"]],
        krylov_iters=[gm["krylov_iters"], wm["krylov_iters"]],
        residual_parts_at=part_at, iterations_part_at=iters_part_at,
        record_within_near_tol_at=floor,
        agree_steps_ok=agree, totals_from_above_ok=above,
        totals_from_below_ok=below,
        functional_err=fn_err, functionals_ok=fn_ok,
        starter_ok=got["starter"]["steps"] == want["starter"]["steps"],
        converged=got["converged"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "records", "torch_dist_history.json"))
    args = ap.parse_args()

    import torch
    from fvens_tpu_torch.dist import launch
    with open(RECORD) as f:
        rec = json.load(f)
    lim, tol_abs = rec["limits"], rec["case"]["config"]["main"]["tol_abs"]
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_dist_history: no CUDA device; pass --device cpu",
                  file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    else:
        card = None
    out = dict(device=args.device, card=card,
               host=dict(machine=platform.machine(), cpus=os.cpu_count(),
                         python=platform.python_version(),
                         torch=torch.__version__),
               limits=lim, runs=[])
    for want in sorted(rec["runs"], key=lambda r: (r["partition"] != "blocks",
                                                    r["parts"])):
        D, partition = want["parts"], want["partition"]
        t0 = time.perf_counter()
        got = launch.run(rank_run, D, args=(partition,),
                         device=args.device, timeout=TIMEOUT,
                         threads=1 if args.device == "cpu" else 0)[0]
        run = dict(parts=D, partition=partition,
                   mesh="cylinder_omesh({}, {})".format(*MESH),
                   world_s=time.perf_counter() - t0,
                   vs_record=compare(got, want, lim, tol_abs), **got)
        print(json.dumps(dict(parts=D, partition=partition,
                              world_s=run["world_s"],
                              **run["vs_record"])), flush=True)
        out["runs"].append(run)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
