"""Main pseudo-time steps to the tolerance, per solve of the window (the
solve's own count, SolveInfo.steps): the continuation's share of
solve_s. A rotation of the free stream leaves it unchanged."""

LAYER = "pseudo-time continuation"
UNIT = "steps"
SOURCE = "program_counter"
BETTER = "lower"
MOVES = "solve_s"
WORKLOADS = ["cyl640-solve"]


def read(obs):
    solves = [s for s in obs.get("solves", ()) if s["ok"]]
    if not solves:
        return None
    return sum(s["main_steps"] for s in solves) / len(solves)
