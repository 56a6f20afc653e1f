"""Segments of main steps from one saved state, through the program's
control-file case (its CLI's objects: the control file and solver options
read as the CLI reads them, SteadyFlowCase's solvers).

Traffic parameters (workloads/<cell>.json "params"):
  aoa_deg        the configuration's angle of attack; the seed picks its
                 sign, the case's mirror image about the chord;
  segment_steps  S, the main steps of a segment: every segment runs
                 SteadyBackwardEuler.solve(max_steps=S) from the saved
                 state, so every segment is the same trajectory;
  warm_steps     main steps run in set-up after the starter.

Set-up runs the starter from free stream (the state the traffic needs)
and saves its state on the device. The window closes when the first
segment that ends after the window's length ends. Three steps of each of
the first harness.CHECKED_UNITS segments are recorded for the check
(their input state, cfl and Krylov iterations, and the state each
produced): the first, one drawn from the seed for that segment, and the
last, whose answer is the segment's final state. So the window's check
covers a new step of the trajectory in each of them, and other steps for
other seeds.
"""

from __future__ import annotations

import os
import sys

import torch

from benchmark import harness, judge
from benchmark.reference.mesh import make_mesh


class Driver:
    def __init__(self, cell, seed: int, device, trace: bool = False,
                 dtype=torch.float64):
        self.cell, self.device = cell, device
        self.trace, self.dtype = trace, dtype
        p = self.params = cell.workload["params"]
        self.rng = harness.seed_rng(seed)
        sign = 1.0 if self.rng.integers(2) else -1.0
        self.aoa = sign * p["aoa_deg"]
        self.n_segments = 0

    def setup(self):
        from fvens_tpu_torch.cases.casesolvers import (SteadyFlowCase,
                                                       build_space,
                                                       initial_state)
        from fvens_tpu_torch.mesh.device_mesh import compile_mesh
        cfg = self.cell.config
        fc = harness.flow_config(cfg, os.path.join(self.cell.bench_dir,
                                                   "configs"), self.aoa)
        self.raw = make_mesh(cfg["mesh"])
        self.mesh = compile_mesh(harness.mesh_data(self.raw), fc.bcs,
                                 dtype=self.dtype, device=self.device)
        self.fc = fc
        case = SteadyFlowCase(fc)
        space = build_space(fc)
        with torch.profiler.record_function("bench.starter"):
            u = case.execute_starter(self.mesh, initial_state(space,
                                                              self.mesh))
        self.saved = u.clone()
        self.solver = case._make_solver(space, fc.main, checkpoint=True)
        self.rec = harness.StepRecorder(self.solver)
        self.solver.solve(self.mesh, self.saved,
                          max_steps=self.params["warm_steps"])
        harness.sync(self.device)

    def _segment(self) -> dict:
        from fvens_tpu_torch.solver.steady import NumericalError
        S = self.params["segment_steps"]
        first = self.rec.calls
        picks = {0, int(self.rng.integers(1, max(S - 1, 2))), S - 1}
        keep = self.n_segments < harness.CHECKED_UNITS
        self.n_segments += 1
        self.rec.take = (lambda i: i - first in picks) if keep else None
        self.rec.kept = []
        out = dict(ok=False)
        try:
            with torch.profiler.record_function("bench.segment"):
                u, info = self.solver.solve(self.mesh, self.saved,
                                            max_steps=S)
            out.update(ok=info.steps == S, steps=info.steps,
                       iters=info.total_lin_iters)
            if out["ok"] and keep:
                # the last step's answer: the segment's final state
                *rest, last = self.rec.kept
                out["checked"] = rest + [dict(last, unew=u)]
            else:
                out["error"] = f"{info.steps} of {S} steps"
        except NumericalError as e:
            out["error"] = f"NumericalError: {e}"
        self.rec.take = None
        self.rec.kept = []
        return out

    def window(self, seconds: float, control: bool = False) -> dict:
        """The window; `control` is unused (a segment is the same unit at
        any precision)."""
        self.segments, window_s, self.trace_out = harness.run_window(
            self._segment, seconds, self.trace, self.device)
        steps = sum(s.get("steps", 0) for s in self.segments)
        for s in self.segments:
            print(f"bench: segment {s['wall_s']:.4f} s, {s.get('steps')} "
                  f"steps, {s.get('iters')} Krylov iterations"
                  + ("" if s["ok"] else f", failed: {s.get('error')}"),
                  file=sys.stderr)
        return dict(attempted=len(self.segments),
                    failed=sum(not s["ok"] for s in self.segments),
                    e2e=dict(main_step_ms=1e3 * window_s / max(steps, 1)))

    def observations(self) -> dict:
        return dict(segments=self.segments, trace=self.trace_out,
                    operators=self._operators)

    def _operators(self) -> dict:
        if getattr(self, "_ops", None) is None:
            self._ops = self._build_operators()
        return self._ops

    def _build_operators(self) -> dict:
        """The bsgs preconditioner that the gather path builds
        (linear.make_preconditioner) from the operators of the first
        segment's last step."""
        from fvens_tpu_torch.solver import linear
        done = [s for s in self.segments if s["ok"] and "checked" in s]
        if not done:
            return {}
        s = done[0]["checked"][-1]
        _, lrhs, ops = self.solver.step_operators(self.mesh, s["u"], s["cfl"])
        if not hasattr(ops, "jac"):
            return {}
        lin = self.fc.linear
        common = dict(x=lrhs, cells=self.mesh.n_cells, nbr_blocks=4,
                      V=lrhs.shape[1], dtype=lrhs.dtype)
        return {"slot_precond": dict(
            common, sweeps=lin.pc_sweeps, fn=linear.make_preconditioner(
                ops.mesh, ops.jac, "bsgs", lin.pc_sweeps))}

    def release(self):
        self.solver = self.rec = self.mesh = self.saved = None

    def check(self, lower_precision: bool = False) -> dict:
        """The numbers compared: over the segments' recorded steps, the
        largest residual gap and step gap (judge.step_gaps)."""
        flow = harness.plain_flow(self.cell.config, self.raw, self.aoa,
                                  self.device)
        steps = [r for s in self.segments if s["ok"]
                 for r in s.get("checked", [])]
        return judge.step_gaps(flow, steps, self.raw.nelem,
                               self.cell.config["plain"], lower_precision)
