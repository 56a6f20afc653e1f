"""Plot preconditioner sweep results from the perftest harness.

Role of the reference's scripts/plotprecinfo.py (which plots BLASTed async
sweep data): reads the JSONL records printed by
`python -m fvens_tpu_torch.cases.perftest` (fields: pc, sweeps, krylov,
avg_wall_s, min_wall_s, steps, total_lin_iters) and plots wall time and
Krylov iterations per configuration.

Usage:
    python -m fvens_tpu_torch.scripts.plotprecinfo perftest.jsonl \
        [--out prec.png]
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="preconditioner sweep plot")
    ap.add_argument("file")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    recs = []
    with open(args.file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            recs.append(json.loads(line))
    if not recs:
        print("no records", file=sys.stderr)
        return 1

    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    labels = [f"{r.get('pc', '?')}x{r.get('sweeps', '?')}" for r in recs]
    wall = [r.get("avg_wall_s", r.get("wall_s", 0.0)) for r in recs]
    iters = [r.get("total_lin_iters", r.get("lin_iters", 0)) for r in recs]

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    ax1.bar(labels, wall)
    ax1.set_ylabel("wall time (s)")
    ax1.tick_params(axis="x", rotation=45)
    ax2.bar(labels, iters, color="tab:orange")
    ax2.set_ylabel("total Krylov iterations")
    ax2.tick_params(axis="x", rotation=45)
    fig.tight_layout()
    if args.out:
        fig.savefig(args.out, dpi=150, bbox_inches="tight")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
