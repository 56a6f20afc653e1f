"""The benchmark solve: laminar viscous NACA0012, banded implicit steady.

The port's twin of the JAX package's bench.py:run_solve:
M 0.5, Re 5000, Roe flux, weighted least-squares gradients, unlimited
LINEAR reconstruction, adiabatic wall + inflow/outflow; backward-Euler
pseudo-time with the exponential CFL ramp 500 -> 5000 to an ABSOLUTE
residual of 1e-10; f32 Jacobian and Krylov solve inside the f64 residual
and update; FGMRES(90) at rtol 1e-2 preconditioned by 6 banded block-Jacobi
sweeps (pc="bsgs", LinearSolverConfig.banded=True).

With `two_phase` (an absolute residual gate) the solve is precision
scheduled, bench.py:run_solve(two_phase=)'s form (cases/precision.py): an
all-f32 phase A to the gate, then phase B in f64 from phase A's last CFL.
bench.py runs this case on the gather path (its LinearSolverConfig.banded
defaults to False); bench_solver's `banded=True` default stays for the
banded kernels' sake, so pass banded=False to reproduce bench.py.

The mesh is named by the caller: the generated O-mesh
naca0012_omesh(ni, nj), by default (160, 80) = 12,800 cells, which the
banded encoding covers fully with 6 bands.
"""

from __future__ import annotations

import torch

from ..config import (BCSpec, FlowCaseConfig, LinearSolverConfig,
                      NonlinearUpdateConfig, NumericsConfig, PhysicsConfig,
                      PseudoTimeConfig)
from ..mesh.device_mesh import compile_mesh
from ..mesh.meshgen import naca0012_omesh
from ..solver.steady import SteadyBackwardEuler
from .casesolvers import build_space, initial_state

TOL_ABS = 1e-10                # absolute residual target (energy norm)
MAX_STEPS = 600                # pseudo-time steps before the solve gives up
BENCH_MESH = (160, 80)         # naca0012_omesh(ni, nj): 12,800 cells

BCS = (BCSpec(marker=2, type="adiabaticwall", values=(0.0,)),
       BCSpec(marker=4, type="inflowoutflow"))


def bench_config() -> FlowCaseConfig:
    pcfg = PhysicsConfig(Minf=0.5, Reinf=5000.0, Tinf=288.15, viscous=True)
    ncfg = NumericsConfig(flux="ROE", gradient="LEASTSQUARES",
                          reconstruction="LINEAR", order2=True)
    return FlowCaseConfig(physics=pcfg, numerics=ncfg, bcs=list(BCS))


def bench_solver(device, mesh=BENCH_MESH, mixed: bool = True,
                 pallas: bool = True, order2: bool = True, banded: bool = True,
                 pc: str = "bsgs", pc_sweeps: int = 6, pipeline: bool = False):
    """(SteadyBackwardEuler, CompiledMesh) of the bench solve on `device`.

    `mesh` is the (ni, nj) of naca0012_omesh; `mixed=False` runs the
    Jacobian and Krylov solve in f64 too; `pallas` selects the CUDA banded
    kernel on a CUDA device (False: the plain PyTorch twins);
    `order2=False` is the first-order (starter) discretization; `banded`,
    `pc` and `pc_sweeps` the linear solver's path and preconditioner;
    `pipeline` the pipelined stepping bench.py runs by default
    (bench.py:run_solve(pipeline=), solver/device_stepping.py)."""
    cfg = bench_config()
    cm = compile_mesh(naca0012_omesh(*mesh), cfg.bcs, dtype=torch.float64,
                      device=device)
    lin = LinearSolverConfig(restart=90, maxiter=90, rtol=1e-2, pc=pc,
                             pc_sweeps=pc_sweeps, mixed_precision=mixed,
                             banded=banded, pallas=pallas)
    pt = PseudoTimeConfig(cfl_init=500.0, cfl_fin=5000.0, tol=1e-16,
                          tol_abs=TOL_ABS, maxiter=MAX_STEPS,
                          pipeline=pipeline)
    solver = SteadyBackwardEuler(build_space(cfg, order2=order2), pt, lin,
                                 NonlinearUpdateConfig("full"))
    return solver, cm


def run_solve(device, mesh=BENCH_MESH, two_phase: float = 0.0, **options):
    """Build the case on `device` and return (solve, mesh) where
    solve(max_steps=None) -> (u, SolveInfo) runs the solve from free stream.
    `options` are bench_solver's. With `two_phase` > 0 the solve is
    precision scheduled with that gate and returns a precision.TwoPhaseInfo
    (its totals phase A's steps plus phase B's; `max_steps` stops phase
    B)."""
    solver, cm = bench_solver(device, mesh, **options)
    if two_phase:
        from .precision import solver_two_phase
        scheduled = solver_two_phase(solver, cm, two_phase)
        u32 = initial_state(solver.space, cm).to(torch.float32)
        return (lambda max_steps=None: scheduled(u32, max_steps)), cm

    def solve(max_steps=None):
        u0 = initial_state(solver.space, cm)
        return solver.solve(cm, u0, max_steps=max_steps)

    return solve, cm
