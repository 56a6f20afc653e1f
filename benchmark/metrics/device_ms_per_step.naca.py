"""Device milliseconds per main step of the traced segment: the union of
the device's activity intervals (benchmark/tracing.py) over its steps.
The card's share of main_step_ms, without the host's time between
launches, so it spreads far less between runs on a shared host."""

LAYER = "device"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "main_step_ms"
WORKLOADS = ["naca640-cli-steps"]


def read(obs):
    tr = obs.get("trace")
    segs = obs.get("segments") or ()
    if not tr or tr["busy_s"] <= 0.0 or not segs or not segs[0]["ok"]:
        return None
    # the first segment is the one traced with the device's activity alone
    return 1e3 * tr["busy_s"] / segs[0]["steps"]
