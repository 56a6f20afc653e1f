"""Time the pipelined 640x320 banded cylinder of the port in a checkout.

    python fvens_tpu_torch/cases/pipelined_step.py [--tree DIR] [--label L]

Runs cases/bigmesh_case.run_solve(pipeline=True) (as `bench.py` runs by
default: a warm-up solve, which builds the kernels and captures the
graphs, then a timed solve; no launch counting) on the card with the
fvens_tpu_torch package of the checkout at DIR (default: the one this file
is in), and prints one JSON line: the card's name and power limit, the
steps, Krylov iterations and final residual, and ms per main and starter
step and per Krylov iteration of the timed solve. Run it by its path: with
--tree it imports the package from DIR, so that one call to the card can
time two commits in turns with the same script (parent, change, change,
parent). Where torch sees no card it exits 1.
"""

import argparse
import json
import os
import subprocess
import sys


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=here,
                    help="the checkout whose fvens_tpu_torch is timed")
    ap.add_argument("--label", default=None,
                    help="a name for the tree in the output")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("pipelined_step: no CUDA device", file=sys.stderr)
        return 1
    from fvens_tpu_torch.cases import bigmesh_case
    if not bigmesh_case.__file__.startswith(tree + os.sep):
        print(f"pipelined_step: imported {bigmesh_case.__file__}, not the "
              f"package in {tree} (run this file by its path)",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    _, rep = bigmesh_case.run_solve(torch.device("cuda", 0), warmup=True,
                                    pipeline=True)
    starter_s = rep["wall_s"] - rep["main_wall_s"]
    keys = ("main_steps", "main_krylov_iters", "starter_steps",
            "starter_krylov_iters", "abs_res", "main_wall_s")
    print("pipelined_step", json.dumps(dict(
        tree=args.label or tree, card=card, **{k: rep[k] for k in keys},
        ms_per_main_step=1e3 * rep["main_wall_s"] / rep["main_steps"],
        ms_per_main_krylov_iter=1e3 * rep["main_wall_s"]
        / rep["main_krylov_iters"],
        ms_per_starter_step=1e3 * starter_s / rep["starter_steps"],
        ms_per_starter_krylov_iter=1e3 * starter_s
        / rep["starter_krylov_iters"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
