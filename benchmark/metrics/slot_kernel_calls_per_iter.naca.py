"""C calls of the gather path's slot kernel per Krylov iteration: the
program's counter slot_kernel (solver/slot_kernels.py: one a matvec, one a
whole bsgs apply), over one segment traced after the window
(benchmark/spans.py). Nothing where the program has no such counter."""

from benchmark import spans

LAYER = "kernels"
UNIT = "calls/iter"
SOURCE = "program_counter"
BETTER = "lower"
MOVES = "main_step_ms"
WORKLOADS = ["naca640-cli-steps"]


def read(obs):
    return spans.per_unit(obs, "counters", "slot_kernel", "iters", 1.0)
