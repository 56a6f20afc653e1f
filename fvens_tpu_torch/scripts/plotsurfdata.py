"""Plot wall surface distributions (Cp, Cf) written by the CLI's --surface.

Role of the reference's scripts/plotsurfdata.py. Input files are the CLI's
surface tables: columns `x y Cp Cf` with a '#' header.

Usage:
    python -m fvens_tpu_torch.scripts.plotsurfdata surf.dat [more.dat ...] \
        [--out surf.png] [--qty cp|cf]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="surface Cp/Cf plot")
    ap.add_argument("files", nargs="+")
    ap.add_argument("--out", default=None)
    ap.add_argument("--qty", default="cp", choices=["cp", "cf"])
    args = ap.parse_args(argv)

    import numpy as np

    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    col = 2 if args.qty == "cp" else 3
    fig, ax = plt.subplots()
    for path in args.files:
        data = np.atleast_2d(np.genfromtxt(path))
        order = np.argsort(data[:, 0])
        ax.plot(data[order, 0], data[order, col], ".-", ms=3, label=path)
    ax.set_xlabel("x")
    ax.set_ylabel("$C_p$" if args.qty == "cp" else "$C_f$")
    if args.qty == "cp":
        ax.invert_yaxis()          # aerodynamic convention
    ax.grid(True, lw=0.3)
    ax.legend()
    if args.out:
        fig.savefig(args.out, dpi=150, bbox_inches="tight")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
