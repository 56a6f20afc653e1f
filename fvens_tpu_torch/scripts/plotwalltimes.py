"""Bar chart of solver wall times across cases/configurations.

Role of the reference's scripts/plotwalltimes.py. Input: whitespace tables
`label wall_s [more columns ignored]` or JSONL records with `label`/
`wall_s` fields.

Usage:
    python -m fvens_tpu_torch.scripts.plotwalltimes times.dat [--out wall.png]
"""

from __future__ import annotations

import argparse
import json
import sys


def _load(path):
    labels, walls = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("{"):
                rec = json.loads(line)
                labels.append(str(rec.get("label", len(labels))))
                walls.append(float(rec.get("wall_s", 0.0)))
            else:
                parts = line.split()
                labels.append(parts[0])
                walls.append(float(parts[1]))
    return labels, walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="wall time comparison")
    ap.add_argument("file")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    labels, walls = _load(args.file)
    if not labels:
        print("no records", file=sys.stderr)
        return 1

    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig, ax = plt.subplots()
    ax.bar(labels, walls)
    ax.set_ylabel("wall time (s)")
    ax.tick_params(axis="x", rotation=45)
    fig.tight_layout()
    if args.out:
        fig.savefig(args.out, dpi=150, bbox_inches="tight")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
