"""The program's launch counters, read in a process of their own.

    python3 -m benchmark.counts --workload <cell> --seed <n>

The counters (fvens_tpu_torch/solver/device_counts) add a small kernel to
every launch they count, and a CUDA graph captured while counting keeps
those adds. So a benchmark run never counts: the unit that its trace
profiles runs the timed program. Where a per-layer metric reads a count,
the traced run starts this before its own work on the card and waits for
it: the cell's set-up with the counters on, one unit of its window at
the same seed, and the driver's counts() printed as one JSON line. Not a
benchmark run: it prints no result line.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("counts: no CUDA device", file=sys.stderr)
        return 1
    cell = harness.resolve_cell(args.workload)
    drv = cell.driver().Driver(cell, args.seed, torch.device("cuda", 0),
                               counting=True)
    drv.setup()
    drv.window(0.0)
    print(json.dumps(drv.counts()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
