"""Grid-convergence plot + observed order of accuracy.

Role of the reference's scripts/ploterr.py: read tables of
(mesh size h, error) — whitespace-separated columns, '#' comments — plot
log-log error vs h and report the final-interval convergence order.

Usage:
    python -m fvens_tpu_torch.scripts.ploterr errs1.dat [errs2.dat ...] \
        [--out err.png] [--hcol 0] [--ecol 1]
"""

from __future__ import annotations

import argparse
import math
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="grid convergence plot")
    ap.add_argument("files", nargs="+")
    ap.add_argument("--out", default=None, help="save figure here")
    ap.add_argument("--hcol", type=int, default=0,
                    help="column holding the mesh size parameter")
    ap.add_argument("--ecol", type=int, default=1,
                    help="column holding the error")
    args = ap.parse_args(argv)

    import numpy as np

    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig, ax = plt.subplots()
    for path in args.files:
        data = np.atleast_2d(np.genfromtxt(path))
        h = data[:, args.hcol]
        e = data[:, args.ecol]
        order = np.argsort(h)
        h, e = h[order], e[order]
        slope = ((math.log10(e[-1]) - math.log10(e[-2]))
                 / (math.log10(h[-1]) - math.log10(h[-2])))
        print(f"{path}: final-interval order = {slope:.4f}")
        ax.loglog(h, e, "o-", label=f"{path} (p={slope:.2f})")
    ax.set_xlabel("mesh size h")
    ax.set_ylabel("error")
    ax.grid(True, which="both", lw=0.3)
    ax.legend()
    if args.out:
        fig.savefig(args.out, dpi=150, bbox_inches="tight")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
