"""The program's spans and counters (io_config/logs.py: span, count, take)
and the CLI's --trace_dir.

On the CPU: off (no profiler recording) a span is one shared null context
that allocates nothing and calls nothing of the profiler; under the CLI's
--trace_dir a small gather-path case (the committed cylinder ctrl on
cylinder_omesh(12, 6), starter capped at 2 steps, main to 1e-1) records
step.residual, step.jacobian, step.krylov and krylov.precond with their
parents, in the Chrome trace too; host_syncs equals the host reads
(Tensor.item, .cpu, .tolist) counted inside the solves independently of
the program; and the solve's history is bit for bit the untraced one's.

Marked `gpu` (skip without a card; no JAX imported): a span's recorded
interval holds the runtime calls that launched its kernels, on the
profiler's clock, traced with the device's activity alone and with the
host's; a CUDA-graph capture records no span, and its replays do.
"""

import contextlib
import io
import json
import os
import time
import tracemalloc

import pytest
import torch

from fvens_tpu_torch.cases import cli
from fvens_tpu_torch.cases.convertformat import write_gmsh2
from fvens_tpu_torch.io_config import logs
from fvens_tpu_torch.mesh.meshgen import cylinder_omesh
from fvens_tpu_torch.solver.steady import SteadyBackwardEuler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTRL_DIR = os.path.join(ROOT, "fvens_tpu_torch", "cases", "ctrl")
STEP_SPANS = {"step.residual", "step.jacobian", "step.krylov",
              "krylov.precond"}


def test_spans_off_record_nothing_and_call_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the profiler was called")
    monkeypatch.setattr(logs._profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    logs.take()
    a, b = logs.span("step.residual"), logs.span("graph.replay")
    assert a is b is logs._NULL
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with logs.span("krylov.precond"):
                logs.count("host_syncs")
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = tracemalloc.Filter(True, logs.__file__)
    grown = [s for s in after.filter_traces([here]).compare_to(
        before.filter_traces([here]), "lineno") if s.size_diff > 0]
    assert grown == []
    assert logs.take() == dict(spans=[], counters={})


def test_spans_nest_and_take_clears():
    logs.take()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with logs.span("step.krylov"):
            with logs.span("krylov.precond"):
                logs.count("host_syncs", 2)
            with logs.span("krylov.precond"):
                pass
        logs.count("host_syncs")
    t = logs.take()
    assert [(s[0], s[1]) for s in t["spans"]] == [
        ("step.krylov", -1), ("krylov.precond", 0), ("krylov.precond", 0)]
    assert all(s[2] <= s[3] for s in t["spans"])
    k, p1, p2 = t["spans"]
    assert k[2] <= p1[2] <= p1[3] <= p2[2] <= p2[3] <= k[3]
    assert t["counters"] == {"host_syncs": 3}
    assert logs.take() == dict(spans=[], counters={})


def _ctrl(tmp):
    """The committed cylinder ctrl, starter capped at 2 steps, main to
    1e-1 (9 main steps at 12x6)."""
    with open(os.path.join(CTRL_DIR, "cylinder.ctrl")) as f:
        text = f.read()
    for old, new in (("tolerance      1e-10", "tolerance      1e-1"),
                     ("max_timesteps  200", "max_timesteps  2")):
        assert old in text
        text = text.replace(old, new)
    path = os.path.join(tmp, "case.ctrl")
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The CLI on the CPU untraced, then with --trace_dir, the host reads
    inside SteadyBackwardEuler.solve counted by patched Tensor methods."""
    tmp = str(tmp_path_factory.mktemp("spans"))
    msh = os.path.join(tmp, "cyl.msh")
    write_gmsh2(msh, cylinder_omesh(12, 6, stretch=1.15 ** (20.0 / 6)))
    ctrl = _ctrl(tmp)
    mp = pytest.MonkeyPatch()
    reads, inside = [0], [False]
    for name in ("item", "cpu", "tolist"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            reads[0] += inside[0]
            return _orig(self, *a, **k)
        mp.setattr(torch.Tensor, name, counted)
    solve = SteadyBackwardEuler.solve

    def solve_counted(self, *a, **k):
        inside[0] = True
        try:
            return solve(self, *a, **k)
        finally:
            inside[0] = False
    mp.setattr(SteadyBackwardEuler, "solve", solve_counted)
    out = {}
    try:
        for name, extra in (("plain", []),
                            ("traced", ["--trace_dir",
                                        os.path.join(tmp, "trace")])):
            hist = os.path.join(tmp, f"{name}.jsonl")
            logs.take()
            reads[0] = 0
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main([ctrl, "--mesh_file", msh, "-options_file",
                               os.path.join(CTRL_DIR, "cylinder.solverc"),
                               "--device", "cpu", "--log_every", "0",
                               "--functionals_every", "2",
                               "--history", hist] + extra)
            assert rc == 0
            with open(hist) as f:
                rows = [json.loads(line) for line in f if line.strip()]
            out[name] = dict(rows=rows, reads=reads[0], table=logs.take())
    finally:
        mp.undo()
    out["trace"] = os.path.join(tmp, "trace", "trace.json")
    return out


def test_cli_trace_records_the_step_spans_with_their_parents(runs):
    spans = runs["traced"]["table"]["spans"]
    names = [s[0] for s in spans]
    assert set(names) == STEP_SPANS
    steps = 2 + len(runs["traced"]["rows"])     # starter + main steps
    for n in ("step.residual", "step.krylov"):
        assert names.count(n) == steps
    # the Jacobian's assembly and the Krylov operators' build
    assert names.count("step.jacobian") == 2 * steps
    for name, parent, s, e in spans:
        assert s <= e
        want = "step.krylov" if name == "krylov.precond" else None
        assert (spans[parent][0] if parent >= 0 else None) == want
        if parent >= 0:
            assert spans[parent][2] <= s and e <= spans[parent][3]
    iters = sum(r["lin_iters"] for r in runs["traced"]["rows"])
    assert names.count("krylov.precond") > iters
    with open(runs["trace"]) as f:
        in_trace = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert STEP_SPANS <= in_trace
    assert runs["plain"]["table"] == dict(spans=[], counters={})


def test_host_syncs_counts_every_read_of_the_solves(runs):
    t = runs["traced"]
    assert t["table"]["counters"]["host_syncs"] == t["reads"] > 0
    assert t["reads"] == runs["plain"]["reads"]


def test_the_history_is_the_same_traced_or_not(runs):
    def strip(rows):
        return [{k: v for k, v in r.items() if k != "wall_s"} for r in rows]
    assert strip(runs["traced"]["rows"]) == strip(runs["plain"]["rows"])
    assert any("CL" in r for r in runs["plain"]["rows"])


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _kernel_launches(prof):
    """(start, end) of each runtime call that launched a kernel, copy or
    set, matched by correlation id."""
    events = list(prof.profiler.kineto_results.events())
    on_device = {e.correlation_id() for e in events
                 if e.device_type() == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation()}
    return [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if e.device_type() != torch.autograd.DeviceType.CUDA
            and e.name().startswith("cu")
            and e.correlation_id() in on_device]


@pytest.mark.gpu
@pytest.mark.parametrize("host", [False, True])
def test_a_span_holds_the_launches_of_its_kernels(cuda, host):
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(1 << 20, device=cuda)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    logs.take()
    with profile(activities=acts) as prof:
        for _ in range(3):
            with logs.span("step.residual"):
                for _ in range(4):
                    x.mul_(1.0001)
            time.sleep(0.002)           # host time between the spans
            with logs.span("step.krylov"):
                x.add_(1.0)
                float(x.sum())
            time.sleep(0.002)
        torch.cuda.synchronize()
    table = logs.take()
    calls, spans = _kernel_launches(prof), table["spans"]
    assert len(spans) == 6 and len(calls) >= 6 * 3
    for s, e in calls:
        holding = [sp for sp in spans if sp[2] <= s and e <= sp[3]]
        assert len(holding) == 1, (s, e, spans)
    per = {}
    for s, _ in calls:
        name = next(sp[0] for sp in spans if sp[2] <= s <= sp[3])
        per[name] = per.get(name, 0) + 1
    assert per["step.residual"] == 12
    assert per["step.krylov"] >= 3 * 2
    assert table["counters"] == {}


@pytest.mark.gpu
def test_a_capture_records_no_span_and_its_replays_do(cuda):
    from torch.profiler import ProfilerActivity, profile
    from fvens_tpu_torch.solver.device_stepping import _Captured
    x = torch.randn(1 << 16, device=cuda)

    def body(ctl):
        with logs.span("step.residual"):
            logs.count("host_syncs")
            return (x * 2 + 1).sin()
    prog = _Captured(cuda)
    logs.take()
    with profile(activities=[ProfilerActivity.CUDA]):
        out = prog.run(body, lambda: None)      # warm-up, capture, replay
        want = out.clone()
        out = prog.run(body, lambda: None)
        torch.cuda.synchronize()
    table = logs.take()
    assert prog.graph is not None
    # the eager warm-up's span, then one graph.replay a run: nothing of
    # the capture
    assert [s[0] for s in table["spans"]] == [
        "step.residual", "graph.replay", "graph.replay"]
    assert table["counters"] == {"host_syncs": 1}
    assert torch.equal(out, want)
