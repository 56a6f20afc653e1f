"""Readings for the limits of `correct`: the numbers compared, for sound
runs of the program and for the controls, over many seeds.

    python3 -m benchmark.control --workload <cell> --seeds a,b,c
        [--control-seeds d,e,f]

For each of --seeds: a sound run (the cell's set-up, one unit of its
window, the checks): one JSON line {"seed", "kind": "sound", numbers}.
For each of --control-seeds, two controls at lower precision:
  - "program_f32": the program's own f32 path (mesh, state, residual,
    update and Krylov solve in float32, the nearest precision below the
    configuration's f64), one unit of the window, checked as usual;
  - "reference_low": the sound run's recorded steps re-checked against
    the reference computed with its residual in f32 and its Jacobian and
    Krylov solve in bf16 (the precisions below the configuration's f64
    and f32).
Each seed runs in a process of its own, as a benchmark run does (the
program's CUDA-graph captures of a third case in one process fail). The
benchmark's own runs never run these.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys

import torch

from benchmark import harness


def readings(cell, seed: int, dtype, control: bool, low: bool,
             device=torch.device("cuda", 0)) -> dict:
    """The checks' numbers of one unit of the cell's window at `dtype`
    (`control`: the driver's control form of the unit), and with `low`
    the reference's lower-precision readings of the same steps."""
    drv = cell.driver().Driver(cell, seed, device, dtype=dtype)
    drv.setup()
    win = drv.window(0.0, control=control)
    drv.release()
    out = {}
    if low:
        out["reference_low"] = drv.check(lower_precision=True)
    out["checked"] = drv.check()
    out["failed"] = win["failed"]
    del drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def one(cell, seed: int, kind: str) -> None:
    """Print the readings of one seed: "sound" (with "reference_low" for
    a control seed: kind "sound+low") or "program_f32"."""
    if kind == "program_f32":
        r = readings(cell, seed, torch.float32, True, False)
        print(json.dumps(dict(seed=seed, kind=kind, failed=r["failed"],
                              **r["checked"])), flush=True)
        return
    r = readings(cell, seed, torch.float64, False, kind == "sound+low")
    print(json.dumps(dict(seed=seed, kind="sound", failed=r["failed"],
                          **r["checked"])), flush=True)
    if "reference_low" in r:
        print(json.dumps(dict(seed=seed, kind="reference_low",
                              **r["reference_low"])), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--one", type=int, default=None,
                    help="run this seed here (a child process)")
    ap.add_argument("--kind", default="sound")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    if args.one is not None:
        one(harness.resolve_cell(args.workload), args.one, args.kind)
        return 0
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    jobs = ([(s, "sound") for s in seeds]
            + [(s, "sound+low") for s in cseeds]
            + [(s, "program_f32") for s in cseeds])
    rc = 0
    for seed, kind in jobs:
        out = subprocess.run([sys.executable, "-m", "benchmark.control",
                              "--workload", args.workload, "--one",
                              str(seed), "--kind", kind],
                             capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        sys.stdout.flush()
        if out.returncode:
            rc = 1
            print(json.dumps(dict(seed=seed, kind=kind, error=out.stderr[
                -1500:])), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
