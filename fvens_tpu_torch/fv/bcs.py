"""Flow boundary conditions: vectorized ghost-state computation.

Computes the ghost (right) conserved state for every physical boundary face
in one batched, branch-free pass: all BC types are evaluated pointwise and
the per-face type code selects the result. Replaces the reference FlowBC
class hierarchy (FVENS src/spatial/abc.cpp:41-437); ghost-state Jacobians
come from torch.func.jacfwd through this function composed with the flux.

Formulas follow the reference exactly, including the in/out switching on the
interior normal Mach number (abc.cpp:49-84) and the subsonic-inflow Riemann
relation with the reference's own (2g - 1) factor (abc.cpp:151-176).
"""

from __future__ import annotations

import torch

from ..config import (BC_ADIABATIC_WALL, BC_DIRICHLET, BC_EXTRAPOLATION,
                      BC_FARFIELD, BC_INFLOWOUTFLOW, BC_ISOTHERMAL_WALL,
                      BC_PERIODIC, BC_SLIPWALL, BC_SUBSONIC_INFLOW)
from ..physics.gas import GasPhysics


def compute_ghost_states(phy: GasPhysics, mesh, u, uinf):
    """Ghost conserved states for all physical boundary faces.

    u:    (NC, 4) cell states (used for interior state and periodic partner)
    uinf: (4,) free-stream state
    returns ug: (NB, 4)
    """
    nb = mesh.n_bfaces
    ins = u[mesh.f_left[:nb]]                      # interior states (NB,4)
    n = mesh.f_normal[:nb]                         # outward normals
    return ghost_state(phy, ins, n, mesh.bc_code, mesh.bc_v0, mesh.bc_v1,
                       uinf, u_partner=u[mesh.f_right[:nb]])


def ghost_state(phy: GasPhysics, ins, n, code, v0, v1, uinf, u_partner=None):
    """Batched ghost state: ins (B,4), n (B,2), code/v0/v1 (B,), uinf (4,).
    Also takes a single face (ins (4,), n (2,), scalar code/v0/v1)."""
    g = phy.g
    rho = ins[..., 0]
    vx = ins[..., 1] / rho
    vy = ins[..., 2] / rho
    vni = vx * n[..., 0] + vy * n[..., 1]
    p = phy.pressure(ins)
    c = torch.sqrt(g * p / rho)
    uinf_b = uinf.to(dtype=ins.dtype).expand(ins.shape)

    # ---- slip wall (abc.cpp:218-226): reflect normal momentum
    gs_slip = torch.stack([
        rho,
        ins[..., 1] - 2.0 * vni * n[..., 0] * rho,
        ins[..., 2] - 2.0 * vni * n[..., 1] * rho,
        ins[..., 3],
    ], dim=-1)

    # ---- farfield (abc.cpp:194-199)
    gs_far = uinf_b

    # ---- inflow-outflow (abc.cpp:49-84): switch on interior normal Mach
    Mni = vni / c
    vmag2 = vx * vx + vy * vy
    e_out = phy.energy_from_pressure(phy.p_inf, rho, vmag2)
    gs_subout = torch.stack([rho, ins[..., 1], ins[..., 2], e_out], dim=-1)
    gs_io = torch.where((Mni <= 0)[..., None], uinf_b,
                        torch.where((Mni < 1)[..., None], gs_subout, ins))

    # ---- extrapolation (abc.cpp:417-423)
    gs_ext = ins

    # ---- adiabatic wall, 2D tangential velocity (abc.cpp:272-280)
    tangmom = v0 * rho
    gs_adia = torch.stack([
        rho,
        2.0 * tangmom * n[..., 1] - ins[..., 1],
        -2.0 * tangmom * n[..., 0] - ins[..., 2],
        ins[..., 3],
    ], dim=-1)

    # ---- isothermal wall (abc.cpp:354-369); v0 = tang. vel, v1 = wall T [K]
    wallT = v1 / phy.Tinf  # non-dimensionalize
    gtemp = 2.0 * wallT - phy.temperature(rho, p)
    gvx = 2.0 * v0 * n[..., 1] - vx
    gvy = -2.0 * v0 * n[..., 0] - vy
    gvm2 = gvx * gvx + gvy * gvy
    gs_iso = torch.stack([
        rho, rho * gvx, rho * gvy,
        phy.energy_from_temperature(gtemp, rho, gvm2),
    ], dim=-1)

    # ---- subsonic inflow, total p/T given (abc.cpp:151-176, Blazek 8.4)
    # NOTE: mirrors the reference's Rminus = vn - c/(2g - 1) expression
    # (abc.cpp:157) for behavioral parity.
    Rminus = vni - c / (2.0 * g - 1.0)
    co2 = c * c + (g - 1.0) / 2.0 * vmag2
    # floors keep sqrt AWAY from 0 so jacfwd through the unselected branch
    # stays finite (sqrt'(0) = inf would poison the BC select under AD)
    q = torch.sqrt(torch.clamp_min(
        (g + 1.0) * co2 / ((g - 1.0) * Rminus * Rminus) - (g - 1.0) / 2.0,
        1e-20))
    cg = -Rminus * (g - 1.0) / (g + 1.0) * (1.0 + q)
    ttotal = v1 / phy.Tinf
    ptotal = v0
    tg = ttotal * cg * cg / co2
    pg = ptotal * (tg / ttotal) ** (g / (g - 1.0))
    rg = phy.density_from_pT(pg, tg)
    vgmag = torch.sqrt(torch.clamp_min(2.0 / (g - 1.0) * (co2 - cg * cg),
                                       1e-20))
    # velocity anti-parallel to the outward face normal (flow enters)
    gs_in = torch.stack([
        rg, -rg * vgmag * n[..., 0], -rg * vgmag * n[..., 1],
        phy.energy_from_pressure(pg, rg, vgmag * vgmag),
    ], dim=-1)

    # ---- periodic: partner interior cell state (mesh.cpp:368-424)
    gs_per = u_partner if u_partner is not None else ins

    sel = lambda bc: (code == bc)[..., None]
    out = torch.where(sel(BC_SLIPWALL), gs_slip,
          torch.where(sel(BC_FARFIELD), gs_far,
          torch.where(sel(BC_INFLOWOUTFLOW), gs_io,
          torch.where(sel(BC_EXTRAPOLATION), gs_ext,
          torch.where(sel(BC_ADIABATIC_WALL), gs_adia,
          torch.where(sel(BC_ISOTHERMAL_WALL), gs_iso,
          torch.where(sel(BC_SUBSONIC_INFLOW), gs_in,
          torch.where(sel(BC_PERIODIC), gs_per,
                      ins))))))))
    return out


def scalar_ghost_state(ins, code, v0):
    """Scalar-problem (diffusion) ghost states: Dirichlet mirror
    u_ghost = 2 b - u_in (reference diffusion.cpp compute_boundary_state)."""
    gs_dir = 2.0 * v0[..., None] - ins
    return torch.where((code == BC_DIRICHLET)[..., None], gs_dir, ins)
