"""Post-processing tools, the JAX package's scripts/ for the port's outputs:
plotconv (the CLI's --history JSONL), plotsurfdata (its --surface table),
ploterr, plotprecinfo (cases.perftest's JSONL), plotstrongscale (walls of
--devices N runs), plotwalltimes and computespeedup. Host tools: each
imports argparse, json and numpy, and matplotlib (Agg backend) only when it
plots, so importing the package pulls none of it in.

    python -m fvens_tpu_torch.scripts.<name> --help
"""
