"""Share of the traced segment in which nothing ran on the card: 1 - the
union of the device's activity intervals over the traced window
(benchmark/tracing.py)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "main_step_ms"
WORKLOADS = ["naca640-cli-steps"]


def read(obs):
    tr = obs.get("trace")
    if not tr or tr["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
