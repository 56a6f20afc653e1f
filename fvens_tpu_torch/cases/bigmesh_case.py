"""The large-mesh case: the inviscid 2D cylinder, starter -> main.

The port's twin of the JAX package's scripts/bench_bigmesh.py:build_case
with `--stop abs`, banded (`--banded`) or on the gather path (without it):
the reference's inviscid 2dcylinder family (M 0.38, HLLC, weighted least
squares, LINEAR reconstruction, slip wall on marker 2, far field on marker
4) on the generated O-mesh
cylinder_omesh(ni, nj, stretch=1.15**(20/nj)), run as SteadyFlowCase:

  - a first-order starter, CFL 50 -> 1000 to a relative residual of 1e-1,
    at most 200 steps;
  - the second-order main solve, CFL 500 -> 5000 to an ABSOLUTE residual of
    1e-10, at most 600 steps, f32 Jacobian and Krylov solve inside the f64
    residual and update, FGMRES(90) at rtol 1e-2 preconditioned by 6
    block-Jacobi sweeps (bsgs): banded by default, on slot gathers with
    GATHER_BSGS, which is scripts/bench_bigmesh.py without `--banded`.
    GATHER_BCSGS is the same case under the JAX package's default
    preconditioner, 3 sweeps of multicolor block SGS.

The other solver options of the JAX package on the gather path, each a
preset of keyword arguments like GATHER_BSGS: GATHER_ILU0 (the
fixed-point block ILU0, 4 factorization sweeps and 3 sweeps per
triangular solve), GATHER_AMG (the aggregation multigrid V-cycle),
GATHER_BLINE (2 sweeps of the line smoother), MATRIX_FREE_JVP and
MATRIX_FREE_FD (bsgs x6 preconditioning the exact JVP or the reference's
finite-difference matvec; the FD shell with the Krylov solve in f64, since
under mixed precision the JAX package's fails) and BSGS_RECYCLE (bsgs x6 with warm start and
GCRO-DR recycling of 16 directions); OPTIONS names them all.

The mesh is named by the caller. At BIGMESH = 640x320 (204,800 cells,
n = 819,200 vector elements) gmres takes its blocked path by itself, whose
basis appends are the row_set kernel; the banded applies are the
banded_apply and banded_bsgs kernels at every size, and the gather path's
operators plain PyTorch.
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
# the linear solver of the gather forms (keyword arguments of case_config,
# build_case and run_solve)
GATHER_BSGS = dict(banded=False, pc="bsgs", pc_sweeps=6)
GATHER_BCSGS = dict(banded=False, pc="bcsgs", pc_sweeps=3)
GATHER_ILU0 = dict(banded=False, pc="ilu0", pc_sweeps=3)
GATHER_AMG = dict(banded=False, pc="amg")
GATHER_BLINE = dict(banded=False, pc="bline", pc_sweeps=2)
MATRIX_FREE_JVP = dict(GATHER_BSGS, matrix_free=True)
# the finite-difference shell in full f64, as the JAX package can run it
MATRIX_FREE_FD = dict(GATHER_BSGS, matrix_free=True, matrix_free_fd=True,
                      mixed_precision=False)
BSGS_RECYCLE = dict(GATHER_BSGS, warm_start=True, deflation_k=16)
OPTIONS = {"ilu0": GATHER_ILU0, "amg": GATHER_AMG, "bline": GATHER_BLINE,
           "mf-jvp": MATRIX_FREE_JVP, "mf-fd": MATRIX_FREE_FD,
           "bsgs-recycle": BSGS_RECYCLE}


def case_config(pallas: bool = True, banded: bool = True, pc: str = "bsgs",
                pc_sweeps: int = 6, **lin) -> FlowCaseConfig:
    """The case's configuration; `pallas` selects the CUDA banded kernels on
    a CUDA device (False: their plain PyTorch twins; the row_set kernel of
    blocked GMRES has no such switch), `banded`, `pc` and `pc_sweeps` the
    linear solver's path and preconditioner, `lin` any other
    LinearSolverConfig field (the presets above)."""
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
        linear=LinearSolverConfig(**dict(
            dict(restart=90, maxiter=90, rtol=1e-2, pc=pc,
                 pc_sweeps=pc_sweeps, mixed_precision=True, banded=banded,
                 pallas=pallas), **lin)),
        nl_update=NonlinearUpdateConfig("full"))


def build_case(device, ni: int, nj: int, pallas: bool = True, **lin):
    """(SteadyFlowCase, CompiledMesh, free-stream u0) on `device`, with the
    mesh cylinder_omesh(ni, nj) compiled at f64; `lin` as case_config's."""
    cfg = case_config(pallas, **lin)
    md = cylinder_omesh(ni, nj, stretch=1.15 ** (20.0 / nj))
    mesh = compile_mesh(md, cfg.bcs, dtype=torch.float64, device=device)
    case = SteadyFlowCase(cfg)
    return case, mesh, initial_state(build_space(cfg), mesh)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_solve(device, mesh=BIGMESH, warmup: bool = True, **lin) -> tuple:
    """Build the case on `device` (`lin` as case_config's) and solve it from free stream, starter then main; with
    `warmup` twice, the first solve a warm-up that is not timed, as
    scripts/bench_bigmesh.py does (its wall time excludes first-use costs).
    Returns (u, report) with report a dict of the timed solve: the linear
    solver, wall time (starter included), starter and main steps and Krylov
    iterations, cell updates per second (cells x main steps / wall),
    absolute and relative residuals, the entropy error, whether gmres ran
    blocked, and `krylov_iters_all`, the Krylov iterations of every solve
    (one basis append each on the blocked path)."""
    case, cm, u0 = build_case(device, *mesh, **lin)
    iters_all = 0
    for _ in range(2 if warmup else 1):
        _sync(device)
        t0 = time.perf_counter()
        u, info = case.solve(cm, u0)
        _sync(device)
        wall = time.perf_counter() - t0
        st = case.starter_info
        iters_all += info.total_lin_iters + st.total_lin_iters
    n = 4 * cm.NC
    cl = case.cfg.linear
    return u, dict(
        mesh=f"cylinder_omesh{tuple(mesh)}", cells=cm.n_cells, n=n,
        banded=cl.banded, pc=cl.pc, pc_sweeps=cl.pc_sweeps,
        matrix_free=cl.matrix_free, matrix_free_fd=cl.matrix_free_fd,
        warm_start=cl.warm_start, deflation_k=cl.deflation_k,
        blocked=n >= linear._BLOCKED_N_THRESHOLD, wall_s=wall,
        starter_steps=st.steps, starter_krylov_iters=st.total_lin_iters,
        main_steps=info.steps, main_krylov_iters=info.total_lin_iters,
        converged=info.converged,
        cell_updates_per_s=cm.n_cells * info.steps / wall,
        abs_res=info.finalres, rel_res=info.finalres / info.initres,
        entropy=entropy_error(build_space(case.cfg), cm, u),
        krylov_iters_all=iters_all)
