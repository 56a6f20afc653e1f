"""The large-mesh case: the inviscid 2D cylinder, starter -> main, banded.

The port's twin of the JAX package's scripts/bench_bigmesh.py:build_case
with banded=True and `--stop abs`: the reference's inviscid 2dcylinder
family (M 0.38, HLLC, weighted least squares, LINEAR reconstruction, slip
wall on marker 2, far field on marker 4) on the generated O-mesh
cylinder_omesh(ni, nj, stretch=1.15**(20/nj)), run as SteadyFlowCase:

  - a first-order starter, CFL 50 -> 1000 to a relative residual of 1e-1,
    at most 200 steps;
  - the second-order main solve, CFL 500 -> 5000 to an ABSOLUTE residual of
    1e-10, at most 600 steps, f32 Jacobian and Krylov solve inside the f64
    residual and update, FGMRES(90) at rtol 1e-2 preconditioned by 6 banded
    block-Jacobi sweeps.

The mesh is named by the caller. At BIGMESH = 640x320 (204,800 cells,
n = 819,200 vector elements) gmres takes its blocked path by itself, whose
basis appends are the row_set kernel; the banded applies are the
banded_apply kernel at every size.
"""

from __future__ import annotations

import time

import torch

from ..config import (BCSpec, FlowCaseConfig, LinearSolverConfig,
                      NonlinearUpdateConfig, NumericsConfig, PhysicsConfig,
                      PseudoTimeConfig)
from ..mesh.device_mesh import compile_mesh
from ..mesh.meshgen import cylinder_omesh
from ..output import entropy_error
from ..solver import linear
from .casesolvers import SteadyFlowCase, build_space, initial_state

TOL_ABS = 1e-10                # absolute residual target (energy norm)
BIGMESH = (640, 320)           # cylinder_omesh(ni, nj): 204,800 cells


def case_config(pallas: bool = True) -> FlowCaseConfig:
    """The case's configuration; `pallas` selects the CUDA banded kernel on
    a CUDA device (False: its plain PyTorch twins; the row_set kernel of
    blocked GMRES has no such switch)."""
    bcs = [BCSpec(marker=2, type="slipwall"),
           BCSpec(marker=4, type="farfield")]
    return FlowCaseConfig(
        physics=PhysicsConfig(Minf=0.38, Tinf=288.15, viscous=False),
        numerics=NumericsConfig(flux="HLLC", gradient="LEASTSQUARES",
                                reconstruction="LINEAR", order2=True),
        bcs=bcs,
        main=PseudoTimeConfig(cfl_init=500.0, cfl_fin=5000.0, tol=1e-16,
                              tol_abs=TOL_ABS, maxiter=600),
        init=PseudoTimeConfig(cfl_init=50.0, cfl_fin=1000.0, tol=1e-1,
                              maxiter=200),
        linear=LinearSolverConfig(restart=90, maxiter=90, rtol=1e-2,
                                  pc="bsgs", pc_sweeps=6,
                                  mixed_precision=True, banded=True,
                                  pallas=pallas),
        nl_update=NonlinearUpdateConfig("full"))


def build_case(device, ni: int, nj: int, pallas: bool = True):
    """(SteadyFlowCase, CompiledMesh, free-stream u0) on `device`, with the
    mesh cylinder_omesh(ni, nj) compiled at f64."""
    cfg = case_config(pallas)
    md = cylinder_omesh(ni, nj, stretch=1.15 ** (20.0 / nj))
    mesh = compile_mesh(md, cfg.bcs, dtype=torch.float64, device=device)
    case = SteadyFlowCase(cfg)
    return case, mesh, initial_state(build_space(cfg), mesh)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_solve(device, mesh=BIGMESH) -> tuple:
    """Build the case on `device` and solve it from free stream twice,
    starter then main each time; the first solve is a warm-up and is not
    timed, as scripts/bench_bigmesh.py does (its wall time excludes
    first-use costs). Returns (u, report) with report a dict of the timed
    solve: wall time (starter included), starter and main steps and Krylov
    iterations, cell updates per second (cells x main steps / wall),
    absolute and relative residuals, the entropy error, whether gmres ran
    blocked, and `krylov_iters_all`, the Krylov iterations of both solves
    (one basis append each on the blocked path)."""
    case, cm, u0 = build_case(device, *mesh)
    iters_all = 0
    for _ in range(2):
        _sync(device)
        t0 = time.perf_counter()
        u, info = case.solve(cm, u0)
        _sync(device)
        wall = time.perf_counter() - t0
        st = case.starter_info
        iters_all += info.total_lin_iters + st.total_lin_iters
    n = 4 * cm.NC
    return u, dict(
        mesh=f"cylinder_omesh{tuple(mesh)}", cells=cm.n_cells, n=n,
        blocked=n >= linear._BLOCKED_N_THRESHOLD, wall_s=wall,
        starter_steps=st.steps, starter_krylov_iters=st.total_lin_iters,
        main_steps=info.steps, main_krylov_iters=info.total_lin_iters,
        converged=info.converged,
        cell_updates_per_s=cm.n_cells * info.steps / wall,
        abs_res=info.finalres, rel_res=info.finalres / info.initres,
        entropy=entropy_error(build_space(case.cfg), cm, u),
        krylov_iters_all=iters_all)
