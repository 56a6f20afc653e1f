"""Inviscid numerical fluxes (Roe and HLLC, the fluxes of the ported cases).

Each flux is a pure, branch-free (torch.where) function of (ul, ur, n) with
the variable index LAST, so the same code runs on one (4,) state pair inside
torch.func.jacfwd and on a whole (F, 4) face batch in the residual.

Formulas follow the reference exactly:
  Roe      anumericalflux.cpp:668-737 (Harten entropy fix, eps = 1e-4 * c_roe)
  HLLC     :1176-1231 (Batten star states, Einfeldt signal speeds)

LLF, Van Leer, AUSM, AUSM+ and HLL are still to be ported; get_flux raises
NotImplementedError for them.
"""

from __future__ import annotations

import torch

from ..config import FLUXES
from ..physics.gas import GasPhysics


def _maybe_freeze(x, frozen: bool):
    """Frozen wave speeds (the reference's linearization) under forward AD."""
    return x.detach() if frozen else x


def _vars(phy: GasPhysics, u, n):
    """velocity, vn, p, H, c for one state (aphysics_defs.hpp:27-38)."""
    rho = u[..., 0]
    vx, vy = u[..., 1] / rho, u[..., 2] / rho
    vn = vx * n[..., 0] + vy * n[..., 1]
    vmag2 = vx * vx + vy * vy
    p = (phy.g - 1.0) * (u[..., 3] - 0.5 * rho * vmag2)
    H = (u[..., 3] + p) / rho
    c = torch.sqrt(phy.g * p / rho)
    return vx, vy, vn, vmag2, p, H, c


def _dirflux(u, n, vn, p):
    return torch.stack([vn * u[..., 0],
                        vn * u[..., 1] + p * n[..., 0],
                        vn * u[..., 2] + p * n[..., 1],
                        vn * (u[..., 3] + p)], dim=-1)


def _roe_averages(phy: GasPhysics, ul, ur, n):
    """(anumericalflux.hpp:175-189)."""
    vxi, vyi, vni, vm2i, pi, Hi, ci = _vars(phy, ul, n)
    vxj, vyj, vnj, vm2j, pj, Hj, cj = _vars(phy, ur, n)
    Rij = torch.sqrt(ur[..., 0] / ul[..., 0])
    rhoij = Rij * ul[..., 0]
    vxij = (Rij * vxj + vxi) / (Rij + 1.0)
    vyij = (Rij * vyj + vyi) / (Rij + 1.0)
    Hij = (Rij * Hj + Hi) / (Rij + 1.0)
    vm2ij = vxij * vxij + vyij * vyij
    vnij = vxij * n[..., 0] + vyij * n[..., 1]
    cij = torch.sqrt((phy.g - 1.0) * (Hij - 0.5 * vm2ij))
    return (vxi, vyi, vni, vm2i, pi, Hi, ci,
            vxj, vyj, vnj, vm2j, pj, Hj, cj,
            rhoij, vxij, vyij, vnij, vm2ij, Hij, cij)


ROE_FIX_EPS = 1.0e-4   # Harten entropy-fix parameter (anumericalflux.cpp:664)


def roe_flux(phy: GasPhysics, ul, ur, n, frozen=False):
    (vxi, vyi, vni, vm2i, pi, Hi, ci,
     vxj, vyj, vnj, vm2j, pj, Hj, cj,
     rhoij, vxij, vyij, vnij, vm2ij, Hij, cij) = _roe_averages(phy, ul, ur, n)
    n0, n1 = n[..., 0], n[..., 1]

    l0 = _maybe_freeze(torch.abs(vnij - cij), frozen)
    l1 = _maybe_freeze(torch.abs(vnij), frozen)
    l3 = _maybe_freeze(torch.abs(vnij + cij), frozen)

    # Harten entropy fix (anumericalflux.cpp:687-697)
    delta = ROE_FIX_EPS * cij
    fix = lambda lam: torch.where(lam < delta,
                                  (lam * lam + delta * delta) / (2.0 * delta),
                                  lam)
    l0, l1, l3 = fix(l0), fix(l1), fix(l3)

    devn = vnj - vni
    dep = pj - pi
    derho = ur[..., 0] - ul[..., 0]

    la0 = l0 * (dep - rhoij * cij * devn) / (2.0 * cij * cij)
    la1 = l1 * (derho - dep / (cij * cij))
    la2 = l1 * rhoij
    la3 = l3 * (dep + rhoij * cij * devn) / (2.0 * cij * cij)

    adu = torch.stack([
        la0 + la1 + la3,
        la0 * (vxij - cij * n0) + la1 * vxij
        + la2 * (vxj - vxi - devn * n0) + la3 * (vxij + cij * n0),
        la0 * (vyij - cij * n1) + la1 * vyij
        + la2 * (vyj - vyi - devn * n1) + la3 * (vyij + cij * n1),
        la0 * (Hij - cij * vnij) + la1 * vm2ij / 2.0
        + la2 * (vxij * (vxj - vxi) + vyij * (vyj - vyi) - vnij * devn)
        + la3 * (Hij + cij * vnij),
    ], dim=-1)

    fi = _dirflux(ul, n, vni, pi)
    fj = _dirflux(ur, n, vnj, pj)
    return 0.5 * (fi + fj - adu)


def _einfeldt_speeds(phy, ul, ur, n):
    (vxi, vyi, vni, vm2i, pi, Hi, ci,
     vxj, vyj, vnj, vm2j, pj, Hj, cj,
     rhoij, vxij, vyij, vnij, vm2ij, Hij, cij) = _roe_averages(phy, ul, ur, n)
    sl = torch.minimum(vni - ci, vnij - cij)
    sr = torch.maximum(vnj + cj, vnij + cij)
    return vni, pi, Hi, vnj, pj, Hj, sl, sr


def _hllc_star(u, n, vn, p, ss, sm):
    """Batten star state (anumericalflux.cpp:1071-1081)."""
    pstar = u[..., 0] * (vn - ss) * (vn - sm) + p
    inv = 1.0 / (ss - sm)
    return torch.stack([
        u[..., 0] * (ss - vn) * inv,
        ((ss - vn) * u[..., 1] + (pstar - p) * n[..., 0]) * inv,
        ((ss - vn) * u[..., 2] + (pstar - p) * n[..., 1]) * inv,
        ((ss - vn) * u[..., 3] - p * vn + pstar * sm) * inv,
    ], dim=-1)


def hllc_flux(phy: GasPhysics, ul, ur, n, frozen=False):
    vni, pi, Hi, vnj, pj, Hj, sl, sr = _einfeldt_speeds(phy, ul, ur, n)
    sl = _maybe_freeze(sl, frozen)
    sr = _maybe_freeze(sr, frozen)
    rl, rr = ul[..., 0], ur[..., 0]
    sm = ((rr * vnj * (sr - vnj) - rl * vni * (sl - vni) + pi - pj)
          / (rr * (sr - vnj) - rl * (sl - vni)))
    sm = _maybe_freeze(sm, frozen)

    fl = _dirflux(ul, n, vni, pi)
    fr = _dirflux(ur, n, vnj, pj)
    # guard the (ss - sm) divisions: only evaluated where sign-definite.
    # jacfwd differentiates both branches of every torch.where, so without
    # the guards an unselected star state's division by zero would leave a
    # NaN tangent behind
    sl_safe = torch.where(sl >= sm, sm - 1.0, sl)
    sr_safe = torch.where(sr <= sm, sm + 1.0, sr)
    ulstr = _hllc_star(ul, n, vni, pi, sl_safe, sm)
    urstr = _hllc_star(ur, n, vnj, pj, sr_safe, sm)

    f_lstar = fl + sl[..., None] * (ulstr - ul)
    f_rstar = fr + sr[..., None] * (urstr - ur)

    sl, sm, sr = sl[..., None], sm[..., None], sr[..., None]
    return torch.where(sl > 0, fl,
                       torch.where(sm > 0, f_lstar,
                                   torch.where(sr >= 0, f_rstar, fr)))


FLUX_FUNCTIONS = {
    "ROE": roe_flux,
    "HLLC": hllc_flux,
}


def get_flux(name: str):
    """Factory (reference afactory.cpp:31-98)."""
    key = name.upper()
    if key in FLUX_FUNCTIONS:
        return FLUX_FUNCTIONS[key]
    if key in FLUXES:
        raise NotImplementedError(
            f"inviscid flux '{name}' is not ported yet (only "
            f"{', '.join(FLUX_FUNCTIONS)} are)")
    raise ValueError(f"unknown inviscid flux '{name}'")
