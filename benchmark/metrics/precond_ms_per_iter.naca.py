"""Device milliseconds per Krylov iteration of the program's span
krylov.precond (each preconditioner apply inside gmres, bsgs x 6 on slot
gathers here: the slot contraction where the solve runs it), over one
segment traced with the device's activity alone after the window
(benchmark/spans.py)."""

from benchmark import spans

LAYER = "FGMRES and preconditioner"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "main_step_ms"
WORKLOADS = ["naca640-cli-steps"]


def read(obs):
    return spans.per_unit(obs, "device_ns", "krylov.precond", "iters", 1e-6)
