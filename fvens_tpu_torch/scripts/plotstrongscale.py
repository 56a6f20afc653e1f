"""Strong-scaling plot: wall time / speedup vs device count.

Role of the reference's scripts/plotstrongscale.py. Input: whitespace
tables with columns `devices wall_s` ('#' comments allowed), e.g. collected
from repeated `--devices N` CLI runs.

Usage:
    python -m fvens_tpu_torch.scripts.plotstrongscale scale.dat \
        [more.dat ...] [--out scale.png]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="strong scaling plot")
    ap.add_argument("files", nargs="+")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np

    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig, ax = plt.subplots()
    for path in args.files:
        data = np.atleast_2d(np.genfromtxt(path))
        order = np.argsort(data[:, 0])
        d, t = data[order, 0], data[order, 1]
        ax.loglog(d, t[0] / t, "o-", label=path)
    lo, hi = ax.get_xlim()
    ax.loglog([lo, hi], [lo / lo, hi / lo], "k--", lw=0.8, label="ideal")
    ax.set_xlabel("devices")
    ax.set_ylabel("speedup")
    ax.grid(True, which="both", lw=0.3)
    ax.legend()
    if args.out:
        fig.savefig(args.out, dpi=150, bbox_inches="tight")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
