"""Krylov iterations per main step over the window's segments (the
solve's own count, SolveInfo.total_lin_iters)."""

LAYER = "FGMRES and preconditioner"
UNIT = "iters/step"
SOURCE = "program_counter"
BETTER = "lower"
MOVES = "main_step_ms"
WORKLOADS = ["naca640-cli-steps"]


def read(obs):
    segs = [s for s in obs.get("segments", ()) if s["ok"]]
    steps = sum(s["steps"] for s in segs)
    if not steps:
        return None
    return sum(s["iters"] for s in segs) / steps
