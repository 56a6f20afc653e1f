"""Blocking device-to-host reads per main step: the program's counter
host_syncs (gmres's norms and Hessenberg columns, the step's residual
norm, functionals, read-backs), over one segment traced after the window
(benchmark/spans.py)."""

from benchmark import spans

LAYER = "FGMRES and preconditioner"
UNIT = "syncs/step"
SOURCE = "program_counter"
BETTER = "lower"
MOVES = "main_step_ms"
WORKLOADS = ["naca640-cli-steps"]


def read(obs):
    return spans.per_unit(obs, "counters", "host_syncs", "steps", 1.0)
