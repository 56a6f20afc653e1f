"""Device milliseconds per main step of the program's span step.jacobian
(the Jacobian, its pseudo-time term and the build of the Krylov operators
and preconditioner), over one segment traced with the device's activity
alone after the window (benchmark/spans.py)."""

from benchmark import spans

LAYER = "Jacobian and operator build"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "main_step_ms"
WORKLOADS = ["naca640-cli-steps"]


def read(obs):
    return spans.per_unit(obs, "device_ns", "step.jacobian", "steps", 1e-6)
