"""The port's precision-scheduled solves, held against the JAX package's
record of the same solves.

    python records/torch_two_phase_history.py [--device cpu] [--out FILE]

Runs fvens_tpu_torch's two forms of precision scheduling
(cases/precision.py) on the runs of records/jax_two_phase_history.py, on
the card (`--device cuda`, the default) or on the CPU (`--device cpu`):

  - "cylinder": bigmesh_case.run_solve's case (banded) on
    cylinder_omesh(160, 80) with two_phase=1e-3, phase B to its 600 steps
    or to 1e-10, then the same case single-phase for its entropy error
    (up to 20 minutes on an 8-core x86-64 host);
  - "bench": bench_case.run_solve(two_phase=1e-3, banded=False) on
    naca0012_omesh(160, 80), the gather path bench.py takes: phase A in
    full, then phase B's first B_STEPS steps, as the record holds them.

Each run is compared with the record's by chip_smoke.two_phase_vs_record
(the record's LIMITS); `--recompare` runs nothing and compares the runs
already written with the record afresh. Writes records/torch_two_phase_history.json: the
device and per form the port's histories in the record's layout beside
the comparison.
"""

import argparse
import json
import os
import platform
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RECORD = os.path.join(ROOT, "records", "jax_two_phase_history.json")
MESH = (160, 80)


def run_cylinder(dev, gate: float) -> dict:
    import torch
    from chip_smoke import history_phase, two_phase_layout
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.cases.casesolvers import build_space
    from fvens_tpu_torch.cases.precision import case_two_phase
    from fvens_tpu_torch.output import entropy_error

    case, cm, u0 = bigmesh_case.build_case(dev, *MESH)
    space = build_space(case.cfg)
    t0 = time.perf_counter()
    # phase B to its maxiter without the solver's verdict (whether it
    # reaches 1e-10 there turns on rounding: the JAX record's two runs)
    u, info = case_two_phase(case, cm, gate)(
        u0.to(torch.float32), max_steps=case.cfg.main.maxiter)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    u1, info1 = case.solve(cm, u0)
    wall1 = time.perf_counter() - t0
    return dict(
        two_phase_layout(info, float(entropy_error(space, cm, u))),
        mesh=f"cylinder_omesh{MESH}", cells=cm.n_cells, host_seconds=wall,
        single_phase=dict(
            starter=history_phase(case.starter_info),
            main=history_phase(info1), converged=bool(info1.converged),
            final_abs_res=float(info1.finalres),
            entropy=float(entropy_error(space, cm, u1)),
            host_seconds=wall1))


def run_bench(dev, gate: float, b_steps: int) -> dict:
    from chip_smoke import two_phase_layout
    from fvens_tpu_torch.cases import bench_case
    solve, cm = bench_case.run_solve(dev, mesh=MESH, two_phase=gate,
                                     banded=False)
    t0 = time.perf_counter()
    _, info = solve(max_steps=b_steps)
    wall = time.perf_counter() - t0
    return dict(two_phase_layout(info), mesh=f"naca0012_omesh{MESH}",
                path="gather", cells=cm.n_cells, host_seconds=wall)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", default="cylinder,bench")
    ap.add_argument("--recompare", action="store_true",
                    help="run nothing: compare the runs already in --out "
                         "with the JAX record afresh")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "records", "torch_two_phase_history.json"))
    args = ap.parse_args()

    import torch
    from chip_smoke import two_phase_vs_record
    with open(RECORD) as f:
        rec = json.load(f)
    out = dict(device=args.device, limits=rec["limits"],
               host=dict(machine=platform.machine(), cpus=os.cpu_count(),
                         python=platform.python_version(),
                         torch=torch.__version__), runs={})
    if os.path.exists(args.out):
        with open(args.out) as f:
            old = json.load(f)
        out["runs"] = old.get("runs", {})
        if args.recompare:
            out.update(device=old["device"], host=old["host"])
    for name in args.only.split(","):
        want = rec["runs"][name]
        if args.recompare:
            run = out["runs"][name]
        elif name == "cylinder":
            run = run_cylinder(args.device, rec["gate"])
        else:
            run = run_bench(args.device, rec["gate"],
                            want["phase_b"]["recorded_steps"])
        run["vs_record"] = two_phase_vs_record(name, run, rec)
        print(name, json.dumps(run["vs_record"]), flush=True)
        out["runs"][name] = run
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
