"""The gather path's preconditioner apply, bsgs x 6 on slot gathers
(linear.make_preconditioner, its slot contraction today), as a share of
its roofline: the bytes of D^-1, four blocks of D^-1 N a cell, v and z
at 3.35 TB/s over its device time (benchmark/roofline.py), on the
operators of a step the window ran."""

from benchmark import roofline

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "main_step_ms"
WORKLOADS = ["naca640-cli-steps"]


def read(obs):
    op = obs["operators"]().get("slot_precond")
    if op is None or not op["x"].is_cuda:
        return None
    return roofline.operator_share(op)
