"""Observability: convergence-history logging, device profiling, and the
program's spans and counters.

Reference equivalents: SteadyStepMonitor + residual-history log files
(FVENS src/ode/aodesolver.cpp:541-558, src/spatial/aoutput.cpp:617-638) and
the -log_view/-DPROFILE build hooks (CMakeLists.txt:218-229). The port of
the JAX package's io_config/logs.py: JSONL step records with the same keys
and a torch.profiler trace context.

Spans and counters record only while a torch.profiler records, and not
inside a CUDA-graph capture (a span there would describe the capture, not
the replays). Off, `span` costs one check of the profiler's enabled flag
and returns a shared null context; `count` the same check. On, a span
enters torch.profiler.record_function (the trace shows it on the kernels'
clock) and appends (name, parent index, start ns, end ns) to an in-memory
table, stamped with time.time_ns(), the clock of the profiler's events;
counters add to the same table. `take()` returns the table and clears it.

The spans: step.residual (the residual of an implicit step,
SteadyBackwardEuler.step_operators), step.jacobian (the Jacobian, its
pseudo-time term and the Krylov operators' build), step.krylov (the step's
gmres or gmres_dr call), krylov.precond (each preconditioner apply inside
them) and graph.replay (each replay of a captured step program,
solver/device_stepping.py). The counter host_syncs counts the blocking
device-to-host reads: gmres's and gmres_dr's, the step's residual norm, a
solve's functionals and every Readback.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch
import torch.autograd.profiler as _profiler


class ConvergenceLogger:
    """Streams per-step monitor records to stdout and/or a JSONL file.

    Record fields mirror SteadyStepMonitor: step, relative/absolute rms
    residual, wall time, linear iterations, CFL.
    """

    def __init__(self, path: str | None = None, print_every: int = 10,
                 label: str = ""):
        self.path = path
        self.print_every = print_every
        self.label = label
        self._f = open(path, "w") if path else None
        self._t0 = time.perf_counter()
        if self.print_every:
            print(f"{label:>12} |  step |   rel res |   abs res |"
                  " lin-its |     cfl | wall(s)")

    def log(self, step: int, relres: float, absres: float,
            lin_iters: int = 0, cfl: float = 0.0, **extras) -> None:
        """extras (entropy/CL/CDp/CDsf from the functional evaluator,
        solver/steady.py functional_every) are merged into the JSONL
        record."""
        wall = time.perf_counter() - self._t0
        rec = {"step": step, "relres": relres, "absres": absres,
               "lin_iters": lin_iters, "cfl": cfl, "wall_s": wall}
        rec.update(extras)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.print_every and (step - 1) % self.print_every == 0:
            print(f"{self.label:>12} | {step:5d} | {relres:9.3e} |"
                  f" {absres:9.3e} | {lin_iters:7d} | {cfl:7.1f} |"
                  f" {wall:7.2f}")

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace of the CPU and, where there is one,
    the CUDA card, written to `logdir` as a Chrome trace (view with
    TensorBoard or chrome://tracing)."""
    import os
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class _Table:
    """The spans and counters recorded since the last take()."""

    def __init__(self):
        self.spans = []         # [name, parent index or -1, start, end]
        self.counters = {}
        self.open = []          # indices of the open spans, innermost last


_table = _Table()
_NULL = contextlib.nullcontext()


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


class _Span:
    __slots__ = ("name", "table", "index", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        t = self.table = _table
        self.index = len(t.spans)
        t.spans.append([self.name, t.open[-1] if t.open else -1,
                        time.time_ns(), 0])
        t.open.append(self.index)
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        t = self.table
        t.spans[self.index][3] = time.time_ns()
        t.open.pop()
        return False


def span(name: str):
    """A context manager that records the block as span `name` while a
    torch.profiler records (outside any CUDA-graph capture); otherwise a
    shared null context."""
    if not _profiler._is_profiler_enabled or _capturing():
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while a torch.profiler records (outside any
    CUDA-graph capture)."""
    if not _profiler._is_profiler_enabled or _capturing():
        return
    c = _table.counters
    c[name] = c.get(name, 0) + n


def take() -> dict:
    """The spans and counters recorded since the last call, and clear
    them: {"spans": [(name, parent index or -1, start ns, end ns)],
    "counters": {name: total}}; a parent index points into the same
    list."""
    global _table
    t, _table = _table, _Table()
    return dict(spans=[tuple(s) for s in t.spans], counters=t.counters)
