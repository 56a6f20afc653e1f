"""Microseconds per Krylov iteration in which the card is idle while the
host is inside the program's span step.krylov (its gmres call, the
preconditioner applies in it included): the host's time between the
Krylov iterations' kernels, over one segment traced with the device's
activity alone after the window (benchmark/spans.py)."""

from benchmark import spans

LAYER = "FGMRES and preconditioner"
UNIT = "us"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "main_step_ms"
WORKLOADS = ["naca640-cli-steps"]


def read(obs):
    return spans.per_unit(obs, "idle_within_ns", "step.krylov", "iters",
                          1e-3)
