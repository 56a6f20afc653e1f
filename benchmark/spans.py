"""The program's spans and counters (fvens_tpu_torch/io_config/logs.py)
reduced against a profiler trace: device time by span, idle time by
span, and the idle time between the nodes of each CUDA-graph replay.

The traced unit is one more unit of the cell's work (a segment, a solve),
run after the window of a traced run, as the rooflines time their
operators after it, and traced with the device's activity alone, whose
cost to the host is small. The program records its spans and counters
only while a profiler records, in a table of its own stamped with the
profiler's clock (time.time_ns()); `logs.take()` hands them over.

  - Device time by span: a kernel, copy or set belongs to the innermost
    span open when its launch was made, its launch being the runtime or
    driver call (`cu*`) with its correlation id; a graph's kernels carry
    their cudaGraphLaunch's. Overlapping device intervals count once: each
    operation adds what it runs beyond those that started before it, so
    the spans' times and the rest ("(no span)", "(no launch)") sum to
    busy_ns, the union of the device intervals.
  - Idle time by span: a stretch of the window in which nothing ran on
    the device is named after the innermost span open at its middle
    ("(no span)" outside them); the names sum to the window less
    busy_ns. `idle_within` adds a gap to the span and to every span
    around it.
  - Gaps between graph nodes: for each replay, the interval from its
    first kernel's start to its last kernel's end, less the union of that
    replay's device intervals.

Only kernels, copies and sets count as device activity: user annotations
drawn on the device's timeline are dropped by their kind. A program
without `logs.take` (before its spans existed) gives nothing to read.
"""

from __future__ import annotations

import collections
import functools
import json
import sys
import time

import numpy as np
import torch

from benchmark import harness

NO_SPAN = "(no span)"
NO_LAUNCH = "(no launch)"
GRAPH_LAUNCH = ("cudaGraphLaunch", "cuGraphLaunch")


def _program_logs():
    """The program's logs module where it records spans, else None."""
    from fvens_tpu_torch.io_config import logs
    return logs if hasattr(logs, "take") else None


def kineto_events(events) -> tuple:
    """(device, host) of a profiler's kineto events: device the kernels,
    copies and sets as (start, end, correlation id), user annotations
    dropped; host the other events as (name, start, correlation id)."""
    dev, host = [], []
    for e in events:
        s = e.start_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((s, s + e.duration_ns(), e.correlation_id()))
        else:
            host.append((e.name(), s, e.correlation_id()))
    return dev, host


def _launches(host) -> tuple:
    """{correlation id: host start of its runtime or driver call} and the
    correlation ids of graph launches. CUPTI's own records (buffer
    requests, module loading) share a launch's id: the call named cu* is
    the launch."""
    when, graphs = {}, set()
    for name, s, corr in host:
        if not corr or not name.startswith("cu"):
            continue
        if corr not in when or s < when[corr]:
            when[corr] = s
        if name in GRAPH_LAUNCH:
            graphs.add(corr)
    return when, graphs


def _innermost(spans, t) -> np.ndarray:
    """Index of the innermost span open at each time of the sorted array t
    (-1 where none is): spans are painted outermost first."""
    depth = []
    for _, parent, _, _ in spans:
        depth.append(0 if parent < 0 else depth[parent] + 1)
    out = np.full(len(t), -1, np.int64)
    for i in sorted(range(len(spans)), key=depth.__getitem__):
        _, _, s, e = spans[i]
        a, b = np.searchsorted(t, [s, e], side="left")
        out[a:b] = i
    return out


def _union_parts(st, en) -> np.ndarray:
    """What each interval (sorted by start) adds to the union of those
    before it; the parts sum to the union's length."""
    if not len(en):
        return en
    prev = np.concatenate([[np.iinfo(np.int64).min],
                           np.maximum.accumulate(en)[:-1]])
    return np.maximum(en - np.maximum(st, prev), 0)


def reduce(dev, host, table: dict, t0_ns: int, t1_ns: int) -> dict:
    """The reduction of one traced unit: `dev` and `host` as
    kineto_events gives them, `table` the program's logs.take() over the
    unit, [t0_ns, t1_ns] the window on the profiler's clock. Raises
    AssertionError where the attribution does not partition busy_ns or
    the idle time."""
    spans = list(table.get("spans", ()))
    names = [s[0] for s in spans]
    when, graphs = _launches(host)
    window = int(t1_ns - t0_ns)
    ops = sorted((max(s, t0_ns), min(e, t1_ns), c) for s, e, c in dev
                 if min(e, t1_ns) > max(s, t0_ns))
    st = np.array([o[0] for o in ops], np.int64)
    en = np.array([o[1] for o in ops], np.int64)
    corr = np.array([o[2] for o in ops], np.int64)
    part = _union_parts(st, en)
    busy = int(part.sum())

    # device time by the innermost span open at each operation's launch
    launch = np.array([when.get(int(c), -1) for c in corr], np.int64)
    order = np.argsort(launch, kind="stable")
    owner = np.empty(len(ops), np.int64)
    owner[order] = _innermost(spans, launch[order])
    owner[launch < 0] = -2
    device = {}
    for i, p in zip(owner.tolist(), part.tolist()):
        k = names[i] if i >= 0 else (NO_SPAN if i == -1 else NO_LAUNCH)
        device[k] = device.get(k, 0) + p
    assert sum(device.values()) == busy, (device, busy)

    # idle gaps of the window by the innermost span open at their middle
    run_end = np.maximum.accumulate(en) if len(en) else en
    new = np.ones(len(st), bool)
    new[1:] = st[1:] > run_end[:-1]
    starts = st[new]
    ends = (np.append(run_end[np.flatnonzero(new)[1:] - 1], run_end[-1])
            if len(st) else en)
    g0 = np.concatenate([[t0_ns], ends])
    g1 = np.concatenate([starts, [t1_ns]])
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    gap_owner = _innermost(spans, (g0 + g1) // 2)
    idle, within, by_index = {}, {}, {}
    for i, g in zip(gap_owner.tolist(), (g1 - g0).tolist()):
        by_index[i] = by_index.get(i, 0) + g
    for i, g in by_index.items():
        k = names[i] if i >= 0 else NO_SPAN
        idle[k] = idle.get(k, 0) + g
        around = set()
        while i >= 0:
            around.add(names[i])
            i = spans[i][1]
        for k in around:
            within[k] = within.get(k, 0) + g
    assert sum(idle.values()) == window - busy, (idle, window, busy)

    # idle time between the nodes of each graph replay
    node_gaps, replays = 0, 0
    if graphs:
        in_graph = np.isin(corr, np.fromiter(graphs, np.int64))
        gi = np.flatnonzero(in_graph)
        gi = gi[np.lexsort((st[gi], corr[gi]))]
        bounds = np.flatnonzero(np.diff(corr[gi])) + 1
        for grp in np.split(gi, bounds):
            if not len(grp):
                continue
            replays += 1
            s, e = st[grp], en[grp]
            node_gaps += int(e.max() - s.min() - _union_parts(s, e).sum())
    return dict(window_ns=window, busy_ns=busy, device_ns=device,
                idle_ns=idle, idle_within_ns=within,
                graph_node_gap_ns=node_gaps, replays=replays,
                span_counts=dict(collections.Counter(names)),
                counters=dict(table.get("counters", {})))


def traced_unit(unit, device) -> dict | None:
    """Run `unit()` under a profiler of the device's activity alone (the
    host's on the CPU) and reduce it with the program's table; None where
    the program records no spans. The result holds the unit's own dict
    under "unit"."""
    logs = _program_logs()
    if logs is None:
        return None
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(device).type == "cuda"
    logs.take()                 # what earlier traced units left
    harness.sync(device)
    with profile(activities=[ProfilerActivity.CUDA if on_card
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        out = unit()
        harness.sync(device)
        t1 = time.time_ns()
    table = logs.take()
    dev, host = kineto_events(prof.profiler.kineto_results.events())
    red = reduce(dev, host, table, t0, t1)
    red["unit"] = {k: v for k, v in out.items()
                   if isinstance(v, (bool, int, float, str))}
    return red


def observe(obs: dict) -> dict | None:
    """The reduction of one more unit of a traced run's cell on the card,
    made once per run and kept on its driver; None off a traced run, off
    the card, or where the program records no spans. The driver comes from
    the observations' `operators` (its bound method); its checked units
    are not added to."""
    drv = getattr(obs.get("operators"), "__self__", None)
    if not obs.get("trace") or drv is None or drv.device.type != "cuda":
        return None
    if "_spans_obs" not in drv.__dict__:
        for attr in ("n_segments", "n_solves"):
            if hasattr(drv, attr):
                setattr(drv, attr, max(getattr(drv, attr),
                                       harness.CHECKED_UNITS))
        unit = getattr(drv, "_segment", None) or functools.partial(
            drv._solve, False)
        red = traced_unit(unit, drv.device)
        drv._spans_obs = red
        if red is not None:
            print("bench: spans " + json.dumps(red), file=sys.stderr)
    return drv._spans_obs


def per_unit(obs: dict, key: str, name: str, per: str, scale: float):
    """The reduction's `key` entry `name` times `scale`, over the traced
    unit's `per` (its steps or Krylov iterations); None where nothing was
    read or the unit failed."""
    red = observe(obs)
    if not red or not red["unit"].get("ok"):
        return None
    n, v = red["unit"].get(per), red[key].get(name)
    if not n or v is None:
        return None
    return v * scale / n
