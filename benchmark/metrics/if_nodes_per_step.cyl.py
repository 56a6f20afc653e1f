"""CUDA-graph IF nodes reached (live or dead) per main step, counted on
the card by the program's launch counters (solver/device_counts
"graph_if") over one solve at the run's seed, in a process of its own
with the counters on (benchmark/counts.py): counting changes the captured
program, so the run itself does not count."""

LAYER = "device-resident stepping"
UNIT = "nodes/step"
SOURCE = "program_counter"
BETTER = "lower"
MOVES = "solve_s"
WORKLOADS = ["cyl640-solve"]


def read(obs):
    counts = obs.get("counts")
    c = counts() if counts else {}
    if not c.get("main_steps") or not c.get("if_nodes_main"):
        return None
    return c["if_nodes_main"] / c["main_steps"]
