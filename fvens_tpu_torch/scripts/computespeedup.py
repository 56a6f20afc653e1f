"""Compute speedups/efficiencies from timing tables.

Role of the reference's scripts/computespeedup.py: read whitespace tables
whose first column is a resource count (threads there, devices here) and a
chosen column of wall times (or bandwidths), normalize by the first row,
and write/plot the speedup.

Usage:
    python -m fvens_tpu_torch.scripts.computespeedup times.dat [--col 1] \
        [--type time|bandwidth] [--out speedup.dat]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="speedup from timing tables")
    ap.add_argument("files", nargs="+")
    ap.add_argument("--col", type=int, default=1,
                    help="data column to convert (0 = resource count)")
    ap.add_argument("--type", default="time", choices=["time", "bandwidth"])
    ap.add_argument("--out", default=None,
                    help="write the converted table here")
    args = ap.parse_args(argv)

    import numpy as np

    for path in args.files:
        data = np.atleast_2d(np.genfromtxt(path))
        base = data[0, args.col]
        if args.type == "time":
            speedup = base / data[:, args.col]
        else:
            speedup = data[:, args.col] / base
        eff = speedup / (data[:, 0] / data[0, 0])
        out = np.column_stack([data[:, 0], speedup, eff])
        print(f"# {path}: resources  speedup  efficiency")
        for row in out:
            print(f"{row[0]:g}  {row[1]:.4f}  {row[2]:.4f}")
        if args.out:
            np.savetxt(args.out, out, header="resources speedup efficiency")
            print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
