"""Model problems with exact solutions, for the steppers and the schemes.

  - The isentropic vortex advecting across a fully periodic box (the
    reference's tests/isentropic-vortex, as the JAX package's
    tests/test_unsteady.py sets it up): vortex_state, vortex_case and
    vortex_errors, integrated with TVD-RK (solver/unsteady.py).
  - The steady heat equation on the unit square with the manufactured
    solution sin(2 pi x) sin(2 pi y) and Dirichlet walls (the reference's
    tests/heat/heat_steady.cpp, as tests/test_heat.py sets it up):
    heat_solver and heat_error, with DiffusionFV (fv/diffusion.py).

Both build their meshes with mesh/meshgen.py and compile them at f64 on the
device named (the card unless the caller passes "cpu").
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import (BCSpec, LinearSolverConfig, NonlinearUpdateConfig,
                      NumericsConfig, PhysicsConfig, PseudoTimeConfig)
from ..fv.diffusion import DiffusionFV
from ..fv.residual import FlowFV
from ..mesh.device_mesh import compile_mesh
from ..mesh.meshgen import _grid_mesh, unit_square
from ..physics.gas import GasPhysics
from ..solver.steady import SteadyBackwardEuler, SteadyForwardEuler

GAMMA = 1.4
VORTEX_MACH = 0.5
VORTEX_EPS = 1.0          # vortex strength
VORTEX_L = 10.0           # box side; the vortex starts at its centre


def vortex_state(xy: np.ndarray, x0: float, y0: float) -> np.ndarray:
    """Exact isentropic vortex in FVENS non-dimensional units
    (rho_inf = |v_inf| = 1, p_inf = 1/(g M^2)): v_theta = A r e^{(1-r^2)/2},
    A = eps/(2 pi); p/rho integrates the radial momentum balance."""
    g = GAMMA
    A = VORTEX_EPS / (2 * math.pi)
    dx = xy[:, 0] - x0
    dy = xy[:, 1] - y0
    r2 = dx * dx + dy * dy
    e = np.exp(0.5 * (1.0 - r2))
    u = 1.0 - A * dy * e
    v = A * dx * e
    Tp = 1.0 / (g * VORTEX_MACH ** 2) - (g - 1.0) / (2 * g) * A * A * e * e
    Tp_inf = 1.0 / (g * VORTEX_MACH ** 2)
    rho = (Tp / Tp_inf) ** (1.0 / (g - 1.0))
    p = rho * Tp
    E = p / (g - 1.0) + 0.5 * rho * (u * u + v * v)
    return np.stack([rho, rho * u, rho * v, E], axis=1)


def vortex_box(n: int):
    """(MeshData, BCs): the n x n quad box [0, L]^2, periodic both ways."""
    xs = np.linspace(0.0, VORTEX_L, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    md = _grid_mesh(X, Y, {"imin": 7, "imax": 7, "jmin": 8, "jmax": 8})
    return md, [BCSpec(marker=7, type="periodic", periodic_axis=0),
                BCSpec(marker=8, type="periodic", periodic_axis=1)]


def vortex_space() -> FlowFV:
    """Euler at M 0.5, Roe, least squares, LINEAR (tests/test_unsteady.py)."""
    return FlowFV(phy=GasPhysics(g=GAMMA, Minf=VORTEX_MACH),
                  pcfg=PhysicsConfig(Minf=VORTEX_MACH, viscous=False),
                  ncfg=NumericsConfig(flux="ROE", gradient="LEASTSQUARES",
                                      reconstruction="LINEAR", order2=True))


def vortex_case(device, n: int):
    """(space, mesh, u0): the vortex at the centre of the n x n box; padded
    cells hold the far-field state."""
    md, bcs = vortex_box(n)
    mesh = compile_mesh(md, bcs, dtype=torch.float64, device=device)
    rc = mesh.rc.cpu().numpy()
    c = VORTEX_L / 2
    u0 = np.tile(vortex_state(np.zeros((1, 2)) + VORTEX_L, c, c),
                 (mesh.NC, 1))
    u0[: mesh.n_cells] = vortex_state(rc[: mesh.n_cells], c, c)
    return (vortex_space(), mesh,
            torch.from_numpy(u0).to(device=device))


def vortex_errors(mesh, u0, u, t: float) -> dict:
    """Mass before and after, and the L2 density error against the exact
    vortex advected by t (periodically wrapped in x), beside the L2 density
    deviation of the initial vortex from the far field."""
    n = mesh.n_cells
    area = mesh.area[:n].cpu().numpy()
    rc = mesh.rc[:n].cpu().numpy()
    u0n, un = u0[:n].cpu().numpy(), u[:n].cpu().numpy()
    c = VORTEX_L / 2
    xc = (c + t) % VORTEX_L
    # the nearest periodic image of the advected centre
    dx = (rc[:, 0] - xc + c) % VORTEX_L - c
    uex = vortex_state(np.stack([dx, rc[:, 1]], axis=1), 0.0, c)
    return dict(
        mass0=float((u0n[:, 0] * area).sum()),
        mass=float((un[:, 0] * area).sum()),
        l2_error=float(np.sqrt(((un[:, 0] - uex[:, 0]) ** 2 * area).sum())),
        l2_vortex=float(np.sqrt(((u0n[:, 0] - 1.0) ** 2 * area).sum())))


def heat_exact(xy: np.ndarray) -> np.ndarray:
    return np.sin(2 * math.pi * xy[:, 0]) * np.sin(2 * math.pi * xy[:, 1])


def heat_source(xy: torch.Tensor) -> torch.Tensor:
    """The source that makes heat_exact the steady solution (nu = 1)."""
    return (8.0 * math.pi ** 2 * torch.sin(2 * math.pi * xy[:, 0])
            * torch.sin(2 * math.pi * xy[:, 1]))[:, None]


def heat_solver(device, n: int, tri: bool, implicit: bool = True, **lin):
    """(solver, mesh): the heat problem on unit_square(n, tri), with the
    settings of tests/test_heat.py: implicit CFL 1e4 to 1e-9 (FGMRES(60) at
    rtol 1e-4, by default bcsgs x3 on slot gathers; `lin` overrides
    LinearSolverConfig fields), or explicit CFL 0.1 to 1e-7 (the
    reference's explls_quad.octrl)."""
    md = unit_square(n, tri=tri)
    mesh = compile_mesh(md, [BCSpec(marker=1, type="dirichlet",
                                    values=(0.0,))],
                        dtype=torch.float64, device=device)
    space = DiffusionFV(diffusivity=1.0, source=heat_source)
    if implicit:
        return SteadyBackwardEuler(
            space,
            PseudoTimeConfig(cfl_init=1e4, cfl_fin=1e4, tol=1e-9,
                             maxiter=300),
            LinearSolverConfig(**dict(dict(maxiter=60, restart=60,
                                           rtol=1e-4), **lin)),
            NonlinearUpdateConfig(scheme="full")), mesh
    return SteadyForwardEuler(
        space, PseudoTimeConfig(cfl_init=0.1, cfl_fin=0.25, tol=1e-7,
                                maxiter=20000)), mesh


def heat_error(mesh, u) -> float:
    """L2 error of the cell values against heat_exact."""
    n = mesh.n_cells
    rc = mesh.rc[:n].cpu().numpy()
    area = mesh.area[:n].cpu().numpy()
    err = u[:n, 0].cpu().numpy() - heat_exact(rc)
    return float(np.sqrt((err ** 2 * area).sum()))


def heat_solve(device, n: int, tri: bool, implicit: bool = True,
               **lin) -> tuple:
    """(L2 error, SolveInfo, mesh) of the heat problem from u = 0."""
    solver, mesh = heat_solver(device, n, tri, implicit, **lin)
    u0 = torch.zeros((mesh.NC, 1), dtype=torch.float64, device=mesh.device)
    u, info = solver.solve(mesh, u0)
    return heat_error(mesh, u), info, mesh
