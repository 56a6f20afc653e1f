"""Observability: convergence-history logging and device profiling.

Reference equivalents: SteadyStepMonitor + residual-history log files
(FVENS src/ode/aodesolver.cpp:541-558, src/spatial/aoutput.cpp:617-638) and
the -log_view/-DPROFILE build hooks (CMakeLists.txt:218-229). The port of
the JAX package's io_config/logs.py: JSONL step records with the same keys,
a torch.profiler trace context, and a wall-clock timer that waits for the
device.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch


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


@contextlib.contextmanager
def timed(name: str, sync=None):
    """Wall-time a block; pass `sync` (a tensor) to wait for its device
    to finish before stopping the clock."""
    t0 = time.perf_counter()
    yield
    if isinstance(sync, torch.Tensor) and sync.is_cuda:
        torch.cuda.synchronize(sync.device)
    print(f"[timed] {name}: {time.perf_counter() - t0:.4f} s")
