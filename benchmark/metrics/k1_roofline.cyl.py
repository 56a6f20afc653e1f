"""The main path's block matvec (the banded matvec the solver builds, K1
today) as a share of its roofline: the bytes of D, four neighbour blocks
a cell, x and y at 3.35 TB/s over its device time (benchmark/roofline.py),
on the operators of a main step the window ran."""

from benchmark import roofline

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "solve_s"
WORKLOADS = ["cyl640-solve"]


def read(obs):
    op = obs["operators"]().get("banded_matvec")
    if op is None or not op["x"].is_cuda:
        return None
    return roofline.operator_share(op)
