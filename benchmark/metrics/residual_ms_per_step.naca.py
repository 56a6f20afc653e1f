"""Device milliseconds per main step of the program's span step.residual
(the residual of an implicit step), over one segment traced with the
device's activity alone after the window (benchmark/spans.py): each
kernel counted in the innermost span open at its launch."""

from benchmark import spans

LAYER = "residual"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "main_step_ms"
WORKLOADS = ["naca640-cli-steps"]


def read(obs):
    return spans.per_unit(obs, "device_ns", "step.residual", "steps", 1e-6)
