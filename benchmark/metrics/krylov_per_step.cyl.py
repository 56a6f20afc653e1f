"""Krylov iterations per pseudo-time step, starter and main, over the
window's solves (the solves' own counts): what one step of FGMRES and
its preconditioner costs in iterations."""

LAYER = "FGMRES and preconditioner"
UNIT = "iters/step"
SOURCE = "program_counter"
BETTER = "lower"
MOVES = "solve_s"
WORKLOADS = ["cyl640-solve"]


def read(obs):
    solves = [s for s in obs.get("solves", ()) if s["ok"]]
    steps = sum(s["starter_steps"] + s["main_steps"] for s in solves)
    if not steps:
        return None
    return sum(s["starter_iters"] + s["main_iters"] for s in solves) / steps
