"""Plot convergence histories from JSONL logs (written by the CLI's
--history flag or ConvergenceLogger).

Equivalent of the reference's scripts/plotconv.py matplotlib
post-processing. Usage:

    python -m fvens_tpu_torch.scripts.plotconv hist1.jsonl [hist2.jsonl ...] \
        [--out conv.png] [--x step|wall_s] [--y relres|absres]
"""

from __future__ import annotations

import argparse
import json
import sys


def load_history(path: str):
    steps, rel, absres, wall = [], [], [], []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            steps.append(rec.get("step", len(steps) + 1))
            rel.append(rec.get("relres", 0.0))
            absres.append(rec.get("absres", 0.0))
            wall.append(rec.get("wall_s", 0.0))
    return {"step": steps, "relres": rel, "absres": absres, "wall_s": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("histories", nargs="+")
    ap.add_argument("--out", default="convergence.png")
    ap.add_argument("--x", default="step", choices=["step", "wall_s"])
    ap.add_argument("--y", default="relres", choices=["relres", "absres"])
    args = ap.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for path in args.histories:
        h = load_history(path)
        ax.semilogy(h[args.x], h[args.y], label=path, lw=1.5)
    ax.set_xlabel(args.x)
    ax.set_ylabel(args.y)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(args.out, dpi=130)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
