"""Inviscid numerical fluxes: LLF, Van Leer FVS, AUSM, AUSM+, Roe(-Pike),
HLL, HLLC.

Each flux is a pure, branch-free (torch.where) function of (ul, ur, n) with
the variable index LAST, so the same code runs on one (4,) state pair inside
torch.func.jacfwd and on a whole (F, 4) face batch in the residual. A
face-scalar select applied to a 4-vector is widened with [..., None].

Formulas follow the reference exactly:
  LLF      anumericalflux.cpp:41-61
  VanLeer  :203-253
  AUSM     :265-317
  AUSM+    :480-556
  Roe      :668-737 (Harten entropy fix, eps = 1e-4 * c_roe)
  HLL      :974-1012 (Einfeldt signal speeds, algebraic 3-term form)
  HLLC     :1176-1231 (Batten star states)
"""

from __future__ import annotations

import torch

from ..physics.gas import GasPhysics


def _maybe_freeze(x, frozen: bool):
    """Frozen wave speeds (the reference's linearization) under forward AD."""
    return x.detach() if frozen else x


def _abs(x):
    """|x| whose forward-mode derivative at 0 is +1, as jnp.abs's is
    (torch.abs gives 0 there): a face normal to a zero velocity component
    (vn = 0 exactly on a symmetry line) or a symmetric slip-wall pair
    (AUSM's Mh = 0) would otherwise give other Jacobian entries."""
    return torch.where(x >= 0, x, -x)


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


def llf_flux(phy: GasPhysics, ul, ur, n, frozen=False):
    _, _, vni, _, pi, _, ci = _vars(phy, ul, n)
    _, _, vnj, _, pj, _, cj = _vars(phy, ur, n)
    eig = _maybe_freeze(torch.maximum(_abs(vni) + ci, _abs(vnj) + cj),
                        frozen)
    fi = _dirflux(ul, n, vni, pi)
    fj = _dirflux(ur, n, vnj, pj)
    return 0.5 * (fi + fj - eig[..., None] * (ur - ul))


def vanleer_flux(phy: GasPhysics, ul, ur, n, frozen=False):
    g = phy.g
    n0, n1 = n[..., 0], n[..., 1]
    vxi, vyi, vni, vm2i, pi, Hi, ci = _vars(phy, ul, n)
    vxj, vyj, vnj, vm2j, pj, Hj, cj = _vars(phy, ur, n)
    Mni, Mnj = vni / ci, vnj / cj

    # left split flux f+
    f0 = ul[..., 0] * ci * (Mni + 1.0) ** 2 / 4.0
    fsub_i = torch.stack([
        f0,
        f0 * (vxi + n0 * (2.0 * ci - vni) / g),
        f0 * (vyi + n1 * (2.0 * ci - vni) / g),
        f0 * ((vm2i - vni * vni) / 2.0
              + ((g - 1.0) * vni + 2.0 * ci) ** 2 / (2.0 * (g * g - 1.0))),
    ], dim=-1)
    full_i = _dirflux(ul, n, vni, pi)
    Mni = Mni[..., None]
    fplus = torch.where(Mni < -1.0, 0.0,
                        torch.where(Mni > 1.0, full_i, fsub_i))

    # right split flux f-
    h0 = -ur[..., 0] * cj * (Mnj - 1.0) ** 2 / 4.0
    fsub_j = torch.stack([
        h0,
        h0 * (vxj + n0 * (-2.0 * cj - vnj) / g),
        h0 * (vyj + n1 * (-2.0 * cj - vnj) / g),
        h0 * ((vm2j - vnj * vnj) / 2.0
              + ((g - 1.0) * vnj - 2.0 * cj) ** 2 / (2.0 * (g * g - 1.0))),
    ], dim=-1)
    full_j = _dirflux(ur, n, vnj, pj)
    Mnj = Mnj[..., None]
    fminus = torch.where(Mnj > 1.0, 0.0,
                         torch.where(Mnj < -1.0, full_j, fsub_j))

    return fplus + fminus


def _pressure_flux(ph, n):
    """(0, ph n_x, ph n_y, 0): the interface pressure term of AUSM/AUSM+."""
    zero = torch.zeros_like(ph)
    return torch.stack([zero, ph * n[..., 0], ph * n[..., 1], zero], dim=-1)


def ausm_flux(phy: GasPhysics, ul, ur, n, frozen=False):
    _, _, vni, _, pi, _, ci = _vars(phy, ul, n)
    _, _, vnj, _, pj, _, cj = _vars(phy, ur, n)
    Mni, Mnj = vni / ci, vnj / cj

    MLs = 0.25 * (Mni + 1.0) ** 2
    ML = torch.where(torch.abs(Mni) <= 1.0, MLs,
                     torch.where(Mni < -1.0, 0.0, Mni))
    pL = torch.where(torch.abs(Mni) <= 1.0, MLs * pi * (2.0 - Mni),
                     torch.where(Mni < -1.0, 0.0, pi))
    MRs = -0.25 * (Mnj - 1.0) ** 2
    MR = torch.where(torch.abs(Mnj) <= 1.0, MRs,
                     torch.where(Mnj < -1.0, Mnj, 0.0))
    pR = torch.where(torch.abs(Mnj) <= 1.0, -MRs * pj * (2.0 + Mnj),
                     torch.where(Mnj < -1.0, pj, 0.0))

    Mh = ML + MR
    ph = pL + pR
    aMh = _abs(Mh)
    phi_l = torch.stack([ul[..., 0] * ci, ul[..., 1] * ci, ul[..., 2] * ci,
                         ci * (ul[..., 3] + pi)], dim=-1)
    phi_r = torch.stack([ur[..., 0] * cj, ur[..., 1] * cj, ur[..., 2] * cj,
                         cj * (ur[..., 3] + pj)], dim=-1)
    return (0.5 * Mh[..., None] * (phi_l + phi_r)
            - 0.5 * aMh[..., None] * (phi_r - phi_l) + _pressure_flux(ph, n))


def ausmplus_flux(phy: GasPhysics, ul, ur, n, frozen=False):
    g = phy.g
    vxi, vyi, vni, vm2i, pi, Hi, ci = _vars(phy, ul, n)
    vxj, vyj, vnj, vm2j, pj, Hj, cj = _vars(phy, ur, n)

    # interface speed of sound (anumericalflux.cpp:497-511)
    csi = torch.sqrt((ci * ci / (g - 1.0) + 0.5 * vm2i)
                     * 2.0 * (g - 1.0) / (g + 1.0))
    csj = torch.sqrt((cj * cj / (g - 1.0) + 0.5 * vm2j)
                     * 2.0 * (g - 1.0) / (g + 1.0))
    corri = torch.maximum(csi, vni)
    corrj = torch.maximum(csj, -vnj)
    csi = csi * csi / corri
    csj = csj * csj / corrj
    ch = torch.minimum(csi, csj)

    Mni, Mnj = vni / ch, vnj / ch

    MLs = 0.25 * (Mni + 1.0) ** 2 + 0.125 * (Mni * Mni - 1.0) ** 2
    pLs = pi * (0.25 * (Mni + 1.0) ** 2 * (2.0 - Mni)
                + 3.0 / 16.0 * Mni * (Mni * Mni - 1.0) ** 2)
    ML = torch.where(torch.abs(Mni) <= 1.0, MLs,
                     torch.where(Mni < -1.0, 0.0, Mni))
    pL = torch.where(torch.abs(Mni) <= 1.0, pLs,
                     torch.where(Mni < -1.0, 0.0, pi))

    MRs = -0.25 * (Mnj - 1.0) ** 2 - 0.125 * (Mnj * Mnj - 1.0) ** 2
    pRs = pj * (0.25 * (Mnj - 1.0) ** 2 * (2.0 + Mnj)
                - 3.0 / 16.0 * Mnj * (Mnj * Mnj - 1.0) ** 2)
    MR = torch.where(torch.abs(Mnj) <= 1.0, MRs,
                     torch.where(Mnj < -1.0, Mnj, 0.0))
    pR = torch.where(torch.abs(Mnj) <= 1.0, pRs,
                     torch.where(Mnj < -1.0, pj, 0.0))

    Mh = ML + MR
    ph = pL + pR
    aMh = _abs(Mh)
    phi_l = torch.stack([ul[..., 0], ul[..., 1], ul[..., 2], ul[..., 3] + pi],
                        dim=-1)
    phi_r = torch.stack([ur[..., 0], ur[..., 1], ur[..., 2], ur[..., 3] + pj],
                        dim=-1)
    return (ch[..., None] * (0.5 * Mh[..., None] * (phi_l + phi_r)
                             - 0.5 * aMh[..., None] * (phi_r - phi_l))
            + _pressure_flux(ph, n))


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


def hll_flux(phy: GasPhysics, ul, ur, n, frozen=False):
    vni, pi, Hi, vnj, pj, Hj, sl, sr = _einfeldt_speeds(phy, ul, ur, n)
    sl = _maybe_freeze(sl, frozen)
    sr = _maybe_freeze(sr, frozen)
    n0, n1 = n[..., 0], n[..., 1]
    zero = torch.zeros_like(sr)
    sr0 = torch.minimum(sr, zero)
    sl0 = torch.minimum(sl, zero)
    t1 = (sr0 - sl0) / (sr - sl)
    t2 = 1.0 - t1
    t3 = 0.5 * (sr * _abs(sl) - sl * _abs(sr)) / (sr - sl)
    return torch.stack([
        t1 * vnj * ur[..., 0] + t2 * vni * ul[..., 0]
        - t3 * (ur[..., 0] - ul[..., 0]),
        t1 * (vnj * ur[..., 1] + pj * n0) + t2 * (vni * ul[..., 1] + pi * n0)
        - t3 * (ur[..., 1] - ul[..., 1]),
        t1 * (vnj * ur[..., 2] + pj * n1) + t2 * (vni * ul[..., 2] + pi * n1)
        - t3 * (ur[..., 2] - ul[..., 2]),
        t1 * (vnj * ur[..., 0] * Hj) + t2 * (vni * ul[..., 0] * Hi)
        - t3 * (ur[..., 3] - ul[..., 3]),
    ], dim=-1)


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
    "LLF": llf_flux,
    "VANLEER": vanleer_flux,
    "AUSM": ausm_flux,
    "AUSMPLUS": ausmplus_flux,
    "ROE": roe_flux,
    "HLL": hll_flux,
    "HLLC": hllc_flux,
}


def get_flux(name: str):
    """Factory (reference afactory.cpp:31-98)."""
    try:
        return FLUX_FUNCTIONS[name.upper()]
    except KeyError:
        raise ValueError(f"unknown inviscid flux '{name}'") from None
