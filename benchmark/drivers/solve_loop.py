"""Closed loop, one client: whole steady solves from free stream, back to
back, through the program's SteadyFlowCase (starter, then the main solve
to its tolerance, then the functionals).

Traffic parameters (workloads/<cell>.json "params"):
  warm_steps      set-up runs this many starter and main steps, which
                  builds the kernels and captures the step programs;
  control_main_steps  main steps of a solve in the control's lower
                  precision, which does not reach the tolerance.
The angle of attack is k * 360 / nt degrees, k drawn from the seed in
[0, nt), nt the configuration's cells around its O-mesh, and the mesh's
numbering around starts k cells on (reference.mesh's `turn`): every seed
poses the same discrete problem, numbering and sweep order included,
turned by whole cells, so the same work. (A free stream turned over a
fixed numbering turns the sweeps' order against the flow: on the card a
solve then takes 58 to 64 main steps by the angle.)

Set-up compiles the mesh and builds the case; the window closes when the
first solve that ends after the window's length ends. The first
harness.CHECKED_UNITS solves keep their final state for the check: the
solver stops once a step's input reads under the main tol_abs and
returns that step's output, whose residual the workload's final_res
bounds. Their first main steps (host-loop steps) are recorded for the
step check and the rooflines. The
program's launch counters change the programs that its CUDA graphs
capture, so a run counts nothing: a traced run on a card first waits for
a process of its own (benchmark/counts.py) to count one solve at the
same seed, before it does any work there.
"""

from __future__ import annotations

import os
import sys

import torch

from benchmark import harness, judge
from benchmark.reference.mesh import make_mesh


class Driver:
    def __init__(self, cell, seed: int, device, trace: bool = False,
                 dtype=torch.float64, counting: bool = False):
        self.cell, self.seed, self.device = cell, seed, device
        self.trace, self.dtype, self.counting = trace, dtype, counting
        nt = cell.config["mesh"]["nt"]
        self.turn = int(harness.seed_rng(seed).integers(nt))
        self.aoa = self.turn * 360.0 / nt
        self.params = cell.workload["params"]
        self._counted = None
        self.n_solves = 0

    def setup(self):
        from fvens_tpu_torch.cases.casesolvers import (SteadyFlowCase,
                                                       build_space)
        from fvens_tpu_torch.mesh.device_mesh import compile_mesh
        from fvens_tpu_torch.solver import device_counts
        if self.trace and self.device.type == "cuda":
            # before this process's work on the card, so that the two
            # never share it
            self._counted = harness.counted_unit(self.cell.name, self.seed)
        cfg = self.cell.config
        fc = harness.flow_config(cfg, os.path.join(self.cell.bench_dir,
                                                   "configs"), self.aoa)
        self.raw = make_mesh(dict(cfg["mesh"], turn=self.turn))
        self.mesh = compile_mesh(harness.mesh_data(self.raw), fc.bcs,
                                 dtype=self.dtype, device=self.device)
        self.fc, self.space = fc, build_space(fc)
        case = self.case = SteadyFlowCase(fc)
        # the case's own solvers, made as its execute_* make them, so that
        # the programs the warm-up captures are the ones the window replays
        case._starter_solver = case._make_solver(
            build_space(fc, order2=False), fc.init)
        case._main_solver = case._make_solver(self.space, fc.main,
                                              checkpoint=True)
        self.rec = harness.StepRecorder(case._main_solver)
        if self.counting:
            # on before the warm-up's captures, which keep the counting
            device_counts.enable(self.device)
        w = self.params["warm_steps"]
        u = case._starter_solver.solve(self.mesh, self._u0(),
                                       max_steps=w)[0]
        u = case._main_solver.solve(self.mesh, u, max_steps=w)[0]
        self._functionals(u)
        harness.sync(self.device)

    def _functionals(self, u):
        from fvens_tpu_torch.output import entropy_error, surface_data
        ent = entropy_error(self.space, self.mesh, u)
        _, (CL, CDp, _) = surface_data(self.space, self.mesh, u,
                                       self.fc.wall_markers)
        return ent, CL, CDp

    def _u0(self):
        from fvens_tpu_torch.cases.casesolvers import initial_state
        return initial_state(self.space, self.mesh)

    def _solve(self, control: bool):
        from fvens_tpu_torch.solver import device_counts
        from fvens_tpu_torch.solver.steady import (NumericalError,
                                                   ToleranceError)
        case, mesh, rf = self.case, self.mesh, torch.profiler.record_function
        out = dict(ok=False)
        first = self.rec.calls
        keep = self.n_solves < harness.CHECKED_UNITS
        self.n_solves += 1
        self.rec.take = (lambda i: i == first) if keep else None
        try:
            with rf("bench.starter"):
                u = case.execute_starter(mesh, self._u0())
            st = case.starter_info
            out.update(starter_steps=st.steps,
                       starter_iters=st.total_lin_iters)
            if self.counting:
                n0 = device_counts.read(self.device)["graph_if"]
            with rf("bench.main"):
                if control:
                    u, info = case._main_solver.solve(
                        mesh, u, max_steps=self.params["control_main_steps"])
                else:
                    u, info = case.execute_main(mesh, u)
            out.update(main_steps=info.steps, main_iters=info.total_lin_iters)
            if self.counting:
                out["if_nodes_main"] = (device_counts.read(self.device)
                                        ["graph_if"] - n0)
            with rf("bench.functionals"):
                fnl = self._functionals(u)
            harness.sync(self.device)
            out.update(ok=True, fnl=fnl)
            if keep:
                out["u"] = u
        except (ToleranceError, NumericalError) as e:
            out["error"] = f"{type(e).__name__}: {e}"
        self.rec.take = None
        return out

    def window(self, seconds: float, control: bool = False) -> dict:
        self.solves, window_s, self.trace_out = harness.run_window(
            lambda: self._solve(control), seconds, self.trace, self.device)
        self.steps = self.rec.kept
        n = len(self.solves)
        failed = sum(not s["ok"] for s in self.solves)
        for s in self.solves:
            print(f"bench: solve {s['wall_s']:.4f} s, "
                  f"{s.get('starter_steps')} + {s.get('main_steps')} steps"
                  + ("" if s["ok"] else f", failed: {s.get('error')}"),
                  file=sys.stderr)
        return dict(attempted=n, failed=failed,
                    e2e=dict(solve_s=window_s / n))

    def observations(self) -> dict:
        """What the per-layer readers read."""
        return dict(solves=self.solves, trace=self.trace_out,
                    operators=self._operators, counts=self._counts)

    def counts(self) -> dict:
        """The program's counts over the window's solves (a counting
        driver's): main steps and IF nodes reached in them."""
        done = [s for s in self.solves if s["ok"] and "if_nodes_main" in s]
        return dict(main_steps=sum(s["main_steps"] for s in done),
                    if_nodes_main=sum(s["if_nodes_main"] for s in done))

    def _counts(self) -> dict:
        """counts() of one solve at this seed, from the process that a
        traced run on a card starts in set-up ({} where none ran)."""
        return self._counted or {}

    def _operators(self) -> dict:
        if getattr(self, "_ops", None) is None:
            self._ops = self._build_operators()
        return self._ops

    def _build_operators(self) -> dict:
        """The Krylov operators of the first recorded main step, as the
        solver builds them: its banded matvec and preconditioner."""
        if not self.steps:
            return {}
        s = self.steps[0]
        sol = self.case._main_solver
        _, lrhs, ops = sol.step_operators(self.mesh, s["u"], s["cfl"])
        mv, pc = sol._linear_operators(ops)
        common = dict(x=lrhs, cells=self.mesh.n_cells, nbr_blocks=4,
                      V=lrhs.shape[1], dtype=lrhs.dtype)
        kind = "banded" if hasattr(ops, "Bt") else "gather"
        return {f"{kind}_matvec": dict(common, fn=mv, sweeps=0),
                f"{kind}_precond": dict(common, fn=pc,
                                        sweeps=self.fc.linear.pc_sweeps)}

    def release(self):
        """Drop the program's case and mesh; keep what check() reads."""
        self.case = self.rec = None
        self.mesh = None

    def check(self, lower_precision: bool = False) -> dict:
        """The numbers compared: the largest over the window's kept solves
        of the reference's residual norm of the final state (final_res) and
        of the functionals' gaps (fnl_gap), and over the recorded first
        main steps of the residual's gap (res_gap) and the step's gap
        (step_gap). `lower_precision`: only the step's numbers, with the
        reference step at the control's precisions (residual f32, Jacobian
        and Krylov bf16)."""
        flow = harness.plain_flow(self.cell.config, self.raw, self.aoa,
                                  self.device)
        nel, plain = self.raw.nelem, self.cell.config["plain"]
        if lower_precision:
            return judge.step_gaps(flow, self.steps, nel, plain, True)
        out = dict(final_res=0.0, fnl_gap=0.0)
        for s in self.solves:
            if not s["ok"] or "u" not in s:
                continue
            u = s["u"][:nel].double()
            out["final_res"] = max(out["final_res"],
                                   judge.residual_norm(flow, u))
            out["fnl_gap"] = max(out["fnl_gap"],
                                 judge.functional_gap(flow, u, s["fnl"]))
        out.update(judge.step_gaps(flow, self.steps, nel, plain))
        return out
