"""Share of a traced solve in which the card is idle between the nodes of
a CUDA-graph replay (the program's span graph.replay around each replay
of the captured step): per replay its first kernel's start to its last
kernel's end, less the union of its device intervals, summed over one
solve traced with the device's activity alone after the window
(benchmark/spans.py)."""

from benchmark import spans

LAYER = "device-resident stepping"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "solve_s"
WORKLOADS = ["cyl640-solve"]


def read(obs):
    red = spans.observe(obs)
    if not red or not red["replays"] or red["window_ns"] <= 0:
        return None
    return 100.0 * red["graph_node_gap_ns"] / red["window_ns"]
