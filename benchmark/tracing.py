"""The traced sub-window: torch.profiler over units of a cell's work (a
solve, a segment), reduced to the device's busy time, the device
operations that took most time and the idle gaps by what the host was
doing.

Two units are traced: the first with the device's activity alone, whose
cost to the host is small, for busy_s, window_s and the device
operations; the second with the host's operators too, whose recording
slows a host-bound loop about twofold, only to name the idle gaps.

busy_s is the union of the device's activity intervals (kernels, copies,
sets) on the traced device, so overlapping operations count once;
window_s the host clock around the traced work, which ends in a device
synchronisation. An idle gap is a stretch of the window in which nothing
ran on the device; it is named after the innermost host event (a
benchmark span, an operator or a CUDA runtime call) that was running at
its middle, and gaps are summed by that name.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

TOP = 10
SPAN_PREFIX = "bench."  # the benchmark's own spans
WINDOW = SPAN_PREFIX + "traced_window"


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _on_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


@contextlib.contextmanager
def traced(device, out: dict, host: bool):
    """Profile the body, the host's operators too where `host`; `out`
    receives the reduction."""
    from torch.profiler import ProfilerActivity, profile
    _sync(device)
    on_card = torch.device(device).type == "cuda"
    acts = (([ProfilerActivity.CUDA] if on_card else [])
            + ([ProfilerActivity.CPU] if host or not on_card else []))
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            yield
            _sync(device)
            window_s = time.perf_counter() - t0
    out.update(reduce_events(prof.profiler.kineto_results.events(),
                             window_s))


def reduce_events(events, window_s: float) -> dict:
    """busy_s, window_s, device_ops and idle_gaps of profiler events, the
    gaps inside the host span WINDOW."""
    dev, host = [], []
    t0_ns = t1_ns = None
    for e in events:
        s, d, n = e.start_ns(), e.duration_ns(), e.name()
        if _on_device(e):
            dev.append((s, s + d, n))
        elif n == WINDOW:
            t0_ns, t1_ns = s, s + d
        else:
            host.append((s, s + d, n))
    # the host's spans are also drawn on the device's timeline under their
    # own names: only kernels, copies and sets are device operations
    spans = {h[2] for h in host}
    dev = [x for x in dev if x[2] not in spans
           and not x[2].startswith(SPAN_PREFIX)]
    if not dev:
        return dict(busy_s=0.0, window_s=window_s, device_ops=[],
                    idle_gaps=[])
    dev.sort()
    st = np.array([x[0] for x in dev], np.int64)
    en = np.array([x[1] for x in dev], np.int64)
    # union of the device intervals
    run_end = np.maximum.accumulate(en)
    new = np.ones(len(st), bool)
    new[1:] = st[1:] > run_end[:-1]
    starts = st[new]
    ends = np.append(run_end[np.flatnonzero(new)[1:] - 1], run_end[-1])
    busy_ns = int((ends - starts).sum())
    by_op = {}
    for s, e, n in dev:
        by_op[n] = by_op.get(n, 0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    # idle gaps: before the first, between and after the last interval,
    # inside the traced span
    lo = int(starts[0]) if t0_ns is None else min(int(starts[0]), t0_ns)
    hi = int(ends[-1]) if t1_ns is None else max(int(ends[-1]), t1_ns)
    g0 = np.concatenate([[lo], ends])
    g1 = np.concatenate([starts, [hi]])
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    mid = (g0 + g1) // 2
    name = np.full(len(mid), -1, np.int64)
    names = []
    # paint the gaps with the host events, longest first, so that the
    # innermost event running at a gap's middle names it
    host.sort(key=lambda x: x[0] - x[1])
    for hs, he, hn in host:
        a, b = np.searchsorted(mid, [hs, he], side="left")
        if b > a:
            name[a:b] = len(names)
            names.append(hn)
    by_gap = {}
    for i, secs in zip(name.tolist(), (g1 - g0).tolist()):
        k = names[i] if i >= 0 else "(no host event)"
        by_gap[k] = by_gap.get(k, 0) + secs
    gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(busy_s=busy_ns * 1e-9, window_s=window_s,
                device_ops=[[n, v * 1e-9] for n, v in ops],
                idle_gaps=[[n, v * 1e-9] for n, v in gaps])
