"""benchmark/spans.py on synthetic events: the device time by span
partitions busy time (overlaps counted once), idle time goes to the
innermost span open at a gap's middle, the gaps between a replay's nodes,
user annotations dropped by kind; and on the CPU the traced unit of a
tiny cell, which no reader reads off the card."""

from __future__ import annotations

import torch

from benchmark import spans
from benchmark.tests.conftest import tiny_cell

# spans: a Krylov solve with a preconditioner apply inside, and a replay
TABLE = dict(spans=[("step.krylov", -1, 100, 1000),
                    ("krylov.precond", 0, 200, 400),
                    ("graph.replay", -1, 1100, 1200)],
             counters={"host_syncs": 7})
HOST = [("cudaLaunchKernel", 150, 1),        # in step.krylov
        ("Activity Buffer Request", 10, 2),  # CUPTI's record, not a launch
        ("cudaLaunchKernel", 250, 2),        # in krylov.precond
        ("cudaLaunchKernel", 50, 3),         # in no span
        ("cudaGraphLaunch", 1150, 4),        # in graph.replay
        ("aten::mul", 160, 0)]
DEV = [(330, 500, 1), (450, 600, 2),         # overlapping: 100 ns count once
       (60, 90, 3), (700, 720, 99),          # 99: no launch traced
       (1300, 1350, 4), (1400, 1450, 4), (1420, 1500, 4)]   # the graph's


def test_device_time_partitions_busy_time():
    r = spans.reduce(DEV, HOST, TABLE, 0, 2000)
    assert r["busy_ns"] == 30 + 270 + 20 + 50 + 100
    assert r["device_ns"] == {"step.krylov": 170, "krylov.precond": 100,
                              spans.NO_SPAN: 30, spans.NO_LAUNCH: 20,
                              "graph.replay": 150}
    assert sum(r["device_ns"].values()) == r["busy_ns"]
    assert r["counters"] == {"host_syncs": 7}
    assert r["span_counts"] == {"step.krylov": 1, "krylov.precond": 1,
                                "graph.replay": 1}


def test_idle_time_goes_to_the_innermost_span():
    r = spans.reduce(DEV, HOST, TABLE, 0, 2000)
    # gaps [0,60] none, [90,330] precond (middle 210), [600,700] krylov,
    # [720,1300] none (middle 1010, between the spans), [1350,1400] none
    # (the replay's span has ended on the host), [1500,2000] none
    assert r["idle_ns"] == {spans.NO_SPAN: 60 + 580 + 50 + 500,
                            "krylov.precond": 240, "step.krylov": 100}
    assert r["idle_within_ns"] == {"krylov.precond": 240,
                                   "step.krylov": 340}
    assert sum(r["idle_ns"].values()) == r["window_ns"] - r["busy_ns"]


def test_gaps_between_graph_nodes():
    r = spans.reduce(DEV, HOST, TABLE, 0, 2000)
    assert r["replays"] == 1
    assert r["graph_node_gap_ns"] == (1500 - 1300) - (50 + 100)
    two = DEV + [(1700, 1710, 5), (1790, 1800, 5)]
    r = spans.reduce(two, HOST + [("cudaGraphLaunch", 1600, 5)], TABLE, 0,
                     2000)
    assert (r["replays"], r["graph_node_gap_ns"]) == (2, 50 + 80)


def test_operations_outside_the_window_are_clipped_and_none_is_empty():
    r = spans.reduce([(-50, 10, 3), (1990, 2100, 3)], HOST, TABLE, 0, 2000)
    assert r["busy_ns"] == 20 and r["device_ns"] == {spans.NO_SPAN: 20}
    r = spans.reduce([], [], dict(spans=[], counters={}), 0, 100)
    assert (r["busy_ns"], r["idle_ns"], r["replays"]) == (
        0, {spans.NO_SPAN: 100}, 0)


class _Event:
    def __init__(self, name, cuda, start, dur, corr, annotation=False):
        self.v = (name, cuda, start, dur, corr, annotation)

    def name(self):
        return self.v[0]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self.v[1]
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self.v[2]

    def duration_ns(self):
        return self.v[3]

    def correlation_id(self):
        return self.v[4]

    def is_user_annotation(self):
        return self.v[5]


def test_user_annotations_on_the_device_are_dropped_by_kind():
    dev, host = spans.kineto_events([
        _Event("step.krylov", True, 100, 900, 1, annotation=True),
        _Event("any_kernel", True, 300, 50, 7),
        _Event("cudaLaunchKernel", False, 150, 5, 7)])
    assert dev == [(300, 350, 7)]
    assert host == [("cudaLaunchKernel", 150, 7)]


def test_the_traced_unit_on_the_cpu_and_no_reading_off_the_card(
        monkeypatch):
    cell = tiny_cell("naca640-cli-steps")
    drv = cell.driver().Driver(cell, 11, torch.device("cpu"), trace=True)
    drv.setup()
    drv.window(0.0)
    r = spans.traced_unit(drv._segment, drv.device)
    steps, iters = r["unit"]["steps"], r["unit"]["iters"]
    assert r["unit"]["ok"] and steps == 3 and iters > 0
    assert r["span_counts"]["step.residual"] == steps
    assert r["span_counts"]["step.krylov"] == steps
    assert r["span_counts"]["krylov.precond"] >= iters
    # classic gmres at this size: bnorm, beta and a column an iteration,
    # and the step's residual norm
    assert r["counters"] == {"host_syncs": iters + 3 * steps}
    assert r["busy_ns"] == 0
    obs = drv.observations()
    assert spans.observe(obs) is None       # a CPU run reads nothing
    monkeypatch.setattr(spans, "_program_logs", lambda: None)
    assert spans.traced_unit(drv._segment, drv.device) is None
