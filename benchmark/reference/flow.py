"""A plain finite-volume discretization of the 2D Euler equations: the
semantics the benchmark holds the program to, written from FVENS's
formulas with nothing of the program imported.

  - geometry: shoelace areas, cell centres as corner means, face normals
    (dy, -dx)/len pointing out of the face's left cell, ghost centres
    mirrored about the face midpoint (FVENS src/mesh/mesh.cpp,
    src/spatial/aspatial.cpp:98-119);
  - ideal gas non-dimensionalized by the free stream, p_inf = 1/(g M^2);
  - boundary ghost states: slip wall (normal momentum reflected), far
    field (the free stream) (src/spatial/abc.cpp);
  - weighted least-squares gradients of the primitive variables (weights
    1/d^2, ghost centres on the boundary), and LINEAR or WENO (gamma 4,
    eps 1e-5, central weight lambda) reconstruction to face midpoints,
    falling back to the cell value where a face state has non-positive
    density or pressure;
  - HLLC (Batten star states, Einfeldt speeds) or LLF fluxes, boundary
    right states from the reconstructed left state;
  - rhs = -(sum of outgoing flux * length) per cell, local time steps
    dt = area / sum of (|vn| + c) * length over the cell's faces (each
    face's side of the cell);
  - the first-order Jacobian of -rhs in cell-slot block form by
    torch.func (forward mode, per face), with the pseudo-time term;
  - the functionals: entropy error and the pressure forces CL, CDp.

Every function takes tensors of one dtype on one device. Per-cell sums
gather the cell's four faces, so the arithmetic repeats exactly.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .mesh import RawMesh

SLIPWALL, FARFIELD = 0, 1
BC_CODES = {"slipwall": SLIPWALL, "farfield": FARFIELD}
WENO_GAMMA = 4.0
WENO_EPS = 1.0e-5


class Geometry:
    """Faces, cells and their metrics of a RawMesh, as tensors."""

    def __init__(self, m: RawMesh, bcs: dict, device, dtype=torch.float64):
        nelem, npoin = m.nelem, m.coords.shape[0]
        a = m.cells.reshape(-1)
        b = np.roll(m.cells, -1, axis=1).reshape(-1)
        elem = np.repeat(np.arange(nelem), 4)
        key = np.minimum(a, b) * npoin + np.maximum(a, b)
        order = np.argsort(key, kind="stable")
        ks = key[order]
        first = np.ones(len(ks), bool)
        first[1:] = ks[1:] != ks[:-1]
        start = np.flatnonzero(first)
        size = np.diff(np.append(start, len(ks)))
        pair, single = start[size == 2], start[size == 1]
        e1, e2 = order[pair], order[pair + 1]          # directed edge ids
        sb = order[single]
        # boundary faces first, then interior; the left cell owns the
        # directed edge (a, b) of its counter-clockwise loop
        f_edge = np.concatenate([sb, e1])
        fL = elem[f_edge]
        fR = np.concatenate([np.full(len(sb), -1), elem[e2]])
        nb = len(sb)
        btag_of = dict(zip((np.minimum(m.bfaces[:, 0], m.bfaces[:, 1])
                            * npoin + np.maximum(m.bfaces[:, 0],
                                                 m.bfaces[:, 1])).tolist(),
                           m.btags.tolist()))
        tags = np.array([btag_of[k] for k in key[sb].tolist()], np.int64)
        code = np.array([BC_CODES[bcs[int(t)]] for t in tags], np.int64)
        # each cell's four faces and its side of them
        cell_faces = np.empty(nelem * 4, np.int64)
        cell_faces[f_edge] = np.arange(len(f_edge))
        cell_faces[e2] = nb + np.arange(len(e2))
        cell_sign = np.ones(nelem * 4)
        cell_sign[e2] = -1.0

        xy = m.coords
        p0, p1 = xy[a[f_edge]], xy[b[f_edge]]
        d = p1 - p0
        flen = np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2)
        normal = np.stack([d[:, 1], -d[:, 0]], 1) / flen[:, None]
        mid = 0.5 * (p0 + p1)
        c = xy[m.cells]                                     # (nelem, 4, 2)

        def tri(i, j, k):
            return 0.5 * (c[:, i, 0] * (c[:, j, 1] - c[:, k, 1])
                          - c[:, i, 1] * (c[:, j, 0] - c[:, k, 0])
                          + c[:, j, 0] * c[:, k, 1] - c[:, k, 0] * c[:, j, 1])
        area = tri(0, 1, 2) + tri(0, 2, 3)
        rc = c.mean(axis=1)
        rcR = np.concatenate([2.0 * mid[:nb] - rc[fL[:nb]], rc[fR[nb:]]])
        dr = rc[fL] - rcR                                   # LSQ direction
        w2 = 1.0 / (dr ** 2).sum(1)

        T = lambda x, dt=dtype: torch.as_tensor(x, dtype=dt, device=device)
        I = lambda x: torch.as_tensor(x, dtype=torch.int64, device=device)
        self.nelem, self.nb, self.nf = nelem, nb, len(f_edge)
        self.fL, self.fR = I(fL), I(np.where(fR < 0, fL, fR))
        self.code, self.tags = I(code), I(tags)
        self.normal, self.len, self.mid = T(normal), T(flen), T(mid)
        self.area, self.rc, self.rcR = T(area), T(rc), T(rcR)
        self.dr, self.w2 = T(dr), T(w2)
        self.cell_faces = I(cell_faces.reshape(nelem, 4))
        self.cell_sign = T(cell_sign.reshape(nelem, 4))
        nbr = np.where(cell_sign > 0, fR[cell_faces], fL[cell_faces])
        self.nbr_mask = T((nbr >= 0).reshape(nelem, 4))
        self.nbr = I(np.where(nbr >= 0, nbr,
                              np.repeat(np.arange(nelem), 4)).reshape(
                                  nelem, 4))
        self.is_wall = (self.code == SLIPWALL)

    def to(self, dtype):
        """A copy with the float fields in `dtype`."""
        g = object.__new__(Geometry)
        for k, v in self.__dict__.items():
            setattr(g, k, v.to(dtype) if torch.is_tensor(v)
                    and v.is_floating_point() else v)
        return g

    def cell_sum(self, face_vals, signed: bool = True):
        """sum over each cell's faces of (sign *) face_vals (nf, ...)."""
        g = face_vals[self.cell_faces]                      # (nelem, 4, ...)
        s = self.cell_sign if signed else torch.ones_like(self.cell_sign)
        s = s.reshape(s.shape + (1,) * (g.dim() - 2))
        return (s * g).sum(dim=1)


class Gas:
    def __init__(self, g: float, Minf: float, aoa_deg: float):
        self.g, self.Minf = g, Minf
        self.aoa = math.radians(aoa_deg)
        self.p_inf = 1.0 / (g * Minf ** 2)

    def uinf(self, dtype, device):
        return torch.tensor([1.0, math.cos(self.aoa), math.sin(self.aoa),
                             self.p_inf / (self.g - 1.0) + 0.5],
                            dtype=dtype, device=device)

    def pressure(self, u):
        return (self.g - 1.0) * (u[..., 3] - 0.5 * (u[..., 1] ** 2
                                                    + u[..., 2] ** 2)
                                 / u[..., 0])

    def prim(self, u):
        r = u[..., 0]
        return torch.stack([r, u[..., 1] / r, u[..., 2] / r,
                            self.pressure(u)], -1)

    def cons(self, w):
        r = w[..., 0]
        E = w[..., 3] / (self.g - 1.0) + 0.5 * r * (w[..., 1] ** 2
                                                    + w[..., 2] ** 2)
        return torch.stack([r, r * w[..., 1], r * w[..., 2], E], -1)

    def ghost(self, ui, n, code, uinf):
        """Slip wall or far-field ghost state of interior states ui."""
        r = ui[..., 0]
        vn = (ui[..., 1] * n[..., 0] + ui[..., 2] * n[..., 1]) / r
        slip = torch.stack([r, ui[..., 1] - 2.0 * vn * n[..., 0] * r,
                            ui[..., 2] - 2.0 * vn * n[..., 1] * r,
                            ui[..., 3]], -1)
        return torch.where((code == SLIPWALL)[..., None], slip,
                           uinf.expand(ui.shape))

    def sound(self, u):
        return torch.sqrt(self.g * self.pressure(u) / u[..., 0])


def _abs(x):
    # |x| with derivative +1 at 0 under forward mode
    return torch.where(x >= 0, x, -x)


def _state(gas, u, n):
    r = u[..., 0]
    vx, vy = u[..., 1] / r, u[..., 2] / r
    vn = vx * n[..., 0] + vy * n[..., 1]
    p = (gas.g - 1.0) * (u[..., 3] - 0.5 * r * (vx * vx + vy * vy))
    return vx, vy, vn, p, (u[..., 3] + p) / r, torch.sqrt(gas.g * p / r)


def _phys_flux(u, n, vn, p):
    return torch.stack([vn * u[..., 0], vn * u[..., 1] + p * n[..., 0],
                        vn * u[..., 2] + p * n[..., 1],
                        vn * (u[..., 3] + p)], -1)


def llf(gas, ul, ur, n):
    _, _, vni, pi, _, ci = _state(gas, ul, n)
    _, _, vnj, pj, _, cj = _state(gas, ur, n)
    eig = torch.maximum(_abs(vni) + ci, _abs(vnj) + cj)
    return 0.5 * (_phys_flux(ul, n, vni, pi) + _phys_flux(ur, n, vnj, pj)
                  - eig[..., None] * (ur - ul))


def hllc(gas, ul, ur, n):
    vxi, vyi, vni, pi, Hi, ci = _state(gas, ul, n)
    vxj, vyj, vnj, pj, Hj, cj = _state(gas, ur, n)
    R = torch.sqrt(ur[..., 0] / ul[..., 0])
    vx = (R * vxj + vxi) / (R + 1.0)
    vy = (R * vyj + vyi) / (R + 1.0)
    H = (R * Hj + Hi) / (R + 1.0)
    vnij = vx * n[..., 0] + vy * n[..., 1]
    cij = torch.sqrt((gas.g - 1.0) * (H - 0.5 * (vx * vx + vy * vy)))
    sl = torch.minimum(vni - ci, vnij - cij)
    sr = torch.maximum(vnj + cj, vnij + cij)
    rl, rr = ul[..., 0], ur[..., 0]
    sm = ((rr * vnj * (sr - vnj) - rl * vni * (sl - vni) + pi - pj)
          / (rr * (sr - vnj) - rl * (sl - vni)))
    fl, fr = _phys_flux(ul, n, vni, pi), _phys_flux(ur, n, vnj, pj)

    def star(u, vn, p, ss):
        pstar = u[..., 0] * (vn - ss) * (vn - sm) + p
        inv = 1.0 / (ss - sm)
        return torch.stack([
            u[..., 0] * (ss - vn) * inv,
            ((ss - vn) * u[..., 1] + (pstar - p) * n[..., 0]) * inv,
            ((ss - vn) * u[..., 2] + (pstar - p) * n[..., 1]) * inv,
            ((ss - vn) * u[..., 3] - p * vn + pstar * sm) * inv], -1)
    # the unselected star states are kept finite (forward mode
    # differentiates both sides of every select)
    fls = fl + sl[..., None] * (star(ul, vni, pi, torch.where(
        sl >= sm, sm - 1.0, sl)) - ul)
    frs = fr + sr[..., None] * (star(ur, vnj, pj, torch.where(
        sr <= sm, sm + 1.0, sr)) - ur)
    sl, sm, sr = sl[..., None], sm[..., None], sr[..., None]
    return torch.where(sl > 0, fl, torch.where(
        sm > 0, fls, torch.where(sr >= 0, frs, fr)))


FLUXES = {"HLLC": hllc, "LLF": llf}


class FlowRef:
    """The discretization of one case: gas, geometry, flux, gradient
    scheme (least squares), reconstruction (LINEAR or WENO with its
    lambda) and the Jacobian's flux."""

    def __init__(self, geo: Geometry, gas: Gas, flux: str = "HLLC",
                 reconstruction: str = "LINEAR", weno_lambda: float = 0.0,
                 jacobian_flux: str | None = None):
        if reconstruction not in ("LINEAR", "WENO"):
            raise ValueError(f"reconstruction {reconstruction!r}")
        self.geo, self.gas = geo, gas
        self.flux = FLUXES[flux.upper()]
        self.jflux = FLUXES[(jacobian_flux or flux).upper()]
        self.recon, self.lam = reconstruction, weno_lambda

    def to(self, dtype):
        f = object.__new__(FlowRef)
        f.__dict__.update(self.__dict__, geo=self.geo.to(dtype))
        return f

    def _gradients(self, w, wg):
        geo, nb = self.geo, self.geo.nb
        wr = torch.cat([wg, w[geo.fR[nb:]]])
        du = w[geo.fL] - wr                                 # (nf, 4)
        rx = (geo.w2 * geo.dr[:, 0])[:, None] * du
        ry = (geo.w2 * geo.dr[:, 1])[:, None] * du
        fx = geo.cell_sum(rx, signed=False)
        fy = geo.cell_sum(ry, signed=False)
        wdd = geo.w2[:, None, None] * geo.dr[:, :, None] * geo.dr[:, None, :]
        V = geo.cell_sum(wdd, signed=False)                 # (nelem, 2, 2)
        det = V[:, 0, 0] * V[:, 1, 1] - V[:, 0, 1] * V[:, 1, 0]
        gx = (V[:, 1, 1, None] * fx - V[:, 0, 1, None] * fy) / det[:, None]
        gy = (V[:, 0, 0, None] * fy - V[:, 1, 0, None] * fx) / det[:, None]
        return torch.stack([gx, gy], 1)                     # (nelem, 2, 4)

    def _weno(self, grads):
        geo = self.geo
        wc = self.lam / ((grads ** 2).sum(1) + WENO_EPS) ** WENO_GAMMA
        gn = grads[geo.nbr]                                 # (nelem, 4, 2, 4)
        wn = geo.nbr_mask[..., None] / ((gn ** 2).sum(2)
                                        + WENO_EPS) ** WENO_GAMMA
        return ((wc[:, None, :] * grads + (wn[:, :, None, :] * gn).sum(1))
                / (wc + wn.sum(1))[:, None, :])

    def face_states(self, u, order2: bool = True):
        """(uL, uR) conserved face states, uR the boundary ghost on the
        boundary faces."""
        geo, gas, nb = self.geo, self.gas, self.geo.nb
        uinf = gas.uinf(u.dtype, u.device)
        if order2:
            ugc = gas.ghost(u[geo.fL[:nb]], geo.normal[:nb], geo.code, uinf)
            w, wg = gas.prim(u), gas.prim(ugc)
            g = self._gradients(w, wg)
            if self.recon == "WENO":
                g = self._weno(g)

            def extrap(cells):
                d = geo.mid - geo.rc[cells]
                gc = g[cells]
                return w[cells] + gc[:, 0] * d[:, 0:1] + gc[:, 1] * d[:, 1:2]
            wL, wR = extrap(geo.fL), extrap(geo.fR)
            bad = lambda x: ((x[:, 0] <= 0.0) | (x[:, 3] <= 0.0))[:, None]
            wL = torch.where(bad(wL), w[geo.fL], wL)
            wR = torch.where(bad(wR), w[geo.fR], wR)
            uL, uR = gas.cons(wL), gas.cons(wR)
        else:
            uL, uR = u[geo.fL], u[geo.fR]
        ug = gas.ghost(uL[:nb], geo.normal[:nb], geo.code, uinf)
        return uL, torch.cat([ug, uR[nb:]])

    def residual(self, u, order2: bool = True):
        """(rhs (nelem, 4), dt (nelem,)) of states u (nelem, 4)."""
        geo, gas = self.geo, self.gas
        uL, uR = self.face_states(u, order2)
        F = self.flux(gas, uL, uR, geo.normal) * geo.len[:, None]
        rhs = -geo.cell_sum(F)
        n = geo.normal
        si = (_abs((uL[:, 1] * n[:, 0] + uL[:, 2] * n[:, 1]) / uL[:, 0])
              + gas.sound(uL)) * geo.len
        sj = (_abs((uR[:, 1] * n[:, 0] + uR[:, 2] * n[:, 1]) / uR[:, 0])
              + gas.sound(uR)) * geo.len
        side = torch.where(geo.cell_sign > 0, si[geo.cell_faces],
                           sj[geo.cell_faces])
        return rhs, geo.area / side.sum(1)

    def residual_norm(self, rhs):
        """sqrt(sum over cells of rhs_energy^2 * area)."""
        return torch.sqrt((rhs[:, 3] ** 2 * self.geo.area).sum())

    def jacobian(self, u, cfl, dt):
        """(D (nelem,4,4), N (nelem,4,4,4)) of the first-order -rhs at u,
        the pseudo-time term area/(cfl dt) on D's diagonal; N[c, k] the
        block of the cell across face k of c (0 on boundary faces)."""
        geo, gas, nb = self.geo, self.gas, self.geo.nb
        uinf = gas.uinf(u.dtype, u.device)
        jf = self.jflux

        def face(ul, ur, n, ln):
            return jf(gas, ul, ur, n) * ln

        def bface(ul, n, ln, code):
            return jf(gas, ul, gas.ghost(ul, n, code, uinf), n) * ln

        A, B = vmap(jacfwd(face, argnums=(0, 1)))(
            u[geo.fL[nb:]], u[geo.fR[nb:]], geo.normal[nb:], geo.len[nb:])
        Db = vmap(jacfwd(bface))(u[geo.fL[:nb]], geo.normal[:nb],
                                 geo.len[:nb], geo.code)
        Z = torch.zeros_like(Db)
        dself = torch.cat([Db, A])                          # d/du_left
        dother = torch.cat([Z, B])                          # d/du_right
        dR_self = torch.cat([Z, -B])                        # right cell's
        dR_other = torch.cat([Z, -A])
        f, left = geo.cell_faces, (geo.cell_sign > 0)[..., None, None]
        Dk = torch.where(left, dself[f], dR_self[f])        # (nelem,4,4,4)
        N = torch.where(left, dother[f], dR_other[f])
        D = Dk.sum(1)
        eye = torch.eye(4, dtype=u.dtype, device=u.device)
        D = D + (geo.area / (cfl * dt))[:, None, None] * eye
        return D, N * geo.nbr_mask[..., None, None]

    def functionals(self, u):
        """(entropy error, CL, CDp) of states u, the forces from the wall
        cells' pressure over the wall faces' total length."""
        geo, gas, nb = self.geo, self.gas, self.geo.nb
        uinf = gas.uinf(u.dtype, u.device)
        sinf = gas.pressure(uinf) / uinf[0] ** gas.g
        s = gas.pressure(u) / u[:, 0] ** gas.g
        ent = torch.sqrt((((s - sinf) / sinf) ** 2 * geo.area).sum())
        wall = geo.is_wall.to(u.dtype)
        n = geo.normal[:nb]
        cp = 2.0 * (gas.pressure(u[geo.fL[:nb]]) - gas.p_inf)
        a = gas.aoa
        ndw = n[:, 0] * math.cos(a) + n[:, 1] * math.sin(a)
        ndn = -n[:, 0] * math.sin(a) + n[:, 1] * math.cos(a)
        w = geo.len[:nb] * wall
        tot = w.sum()
        return ent, (cp * ndn * w).sum() / tot, (cp * ndw * w).sum() / tot
