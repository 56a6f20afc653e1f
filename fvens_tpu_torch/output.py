"""Output functionals: entropy-production error, surface data and force
coefficients (CL, CDp, CDsf), and the cell and point tables of the output
files.

PyTorch port of the JAX package's output.py (reference FVENS
src/spatial/aoutput.cpp:28-62 (entropy) and src/spatial/flow_spatial.cpp:
130-310 (computeSurfaceData)). The sums run in the JAX package's order:
wall mask, then sum, then divide by the total wall length. Tables handed to
NumPy are copied to the host explicitly.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .fv.gradients import get_gradient_scheme


@dataclasses.dataclass
class FlowSolutionFunctionals:
    """(ref casesolvers.hpp FlowSolutionFunctionals)"""
    mesh_size: float = 0.0
    entropy: float = 0.0
    CL: float = 0.0
    CDp: float = 0.0
    CDsf: float = 0.0


def _entropy_error(space, mesh, u: torch.Tensor) -> torch.Tensor:
    phy = space.phy
    sinf = phy.entropy(space.uinf(u.dtype, u.device))
    serr = (phy.entropy(u) - sinf) / sinf
    return torch.sqrt((serr * serr * mesh.area * mesh.cell_mask).sum())


def entropy_error(space, mesh, u: torch.Tensor) -> float:
    """L2 norm of relative entropy production vs free stream
    (aoutput.cpp:28-62): sqrt( sum ((s-s_inf)/s_inf)^2 * area )."""
    return float(_entropy_error(space, mesh, u))


def conserved_gradients(space, mesh, u: torch.Tensor) -> torch.Tensor:
    """Gradients of the CONSERVED variables with BC ghost states, as used for
    surface post-processing (flow_spatial.cpp:95-111 getGradients);
    (NC, 2, 4)."""
    ug = space.ghost_states(mesh, u, space.uinf(u.dtype, u.device))
    return get_gradient_scheme(space.ncfg.gradient)(mesh, u, ug)


def point_data(md, cell_values: np.ndarray) -> np.ndarray:
    """Area-weighted cell->node averaging for point output
    (aoutput.cpp:97-150 postprocess_point). cell_values (nelem, K) host
    array -> (npoin, K)."""
    from .mesh.geometry import compute_geometry
    from .mesh.topology import build_topology
    topo = build_topology(md)
    geom = compute_geometry(md, topo)
    npoin = md.npoin
    K = cell_values.shape[1]
    acc = np.zeros((npoin, K))
    wsum = np.zeros(npoin)
    for k in range(md.inpoel.shape[1]):
        valid = k < md.nnode
        nodes = np.where(valid, md.inpoel[:, k], 0)
        w = np.where(valid, geom.area, 0.0)
        np.add.at(acc, nodes, w[:, None] * cell_values)
        np.add.at(wsum, nodes, w)
    wsum[wsum == 0] = 1.0
    return acc / wsum[:, None]


def cell_fields(space, mesh, u: torch.Tensor) -> dict:
    """Host arrays of the real cells: the state `u`, pressure `p` and
    temperature `T` (computed on the tensors' device, in their dtype),
    velocity `v` and Mach number `mach`."""
    phy = space.phy
    un = u[: mesh.n_cells]
    p = phy.pressure(un)
    T = phy.temperature(un[:, 0], p)
    un, p, T = (t.detach().cpu().numpy() for t in (un, p, T))
    v = un[:, 1:3] / un[:, 0:1]
    c = np.sqrt(space.pcfg.gamma * p / un[:, 0])
    return dict(u=un, p=p, T=T, v=v, mach=np.sqrt((v ** 2).sum(1)) / c)


def volume_data(space, mesh, u: torch.Tensor) -> np.ndarray:
    """Cell-centre postprocessing table: x, y, rho, vx, vy, p, T, Mach
    (aoutput.cpp:150-299 volume dumps); a host array."""
    f = cell_fields(space, mesh, u)
    rc = mesh.rc[: mesh.n_cells].detach().cpu().numpy()
    return np.column_stack([rc, f["u"][:, 0], f["v"], f["p"], f["T"],
                            f["mach"]])


def _wall_cp_cf(space, grads, urec, n):
    """Pointwise wall coefficients on a batch of faces: Cp = 2 (p - p_inf);
    Cf = 2 tau_w with tau_w from the cell-centred conserved-variable
    gradients via the quotient rule (flow_spatial.cpp:225-230). The
    viscosity is evaluated for Euler flow too, as in the JAX package."""
    phy = space.phy
    tangf = torch.stack([n[:, 1], -n[:, 0]], dim=1)       # n x k

    p = phy.pressure(urec)
    cp = (p - phy.p_inf) * 2.0

    muhat = phy.viscosity(urec)
    rho = urec[:, 0]
    g = grads
    gradu = (g[:, :, 1:3] * rho[:, None, None]
             - urec[:, None, 1:3] * g[:, :, 0:1]) / (rho ** 2)[:, None, None]
    gradu = gradu.transpose(1, 2)                         # (W, i=vel, j=dir)
    force = ((gradu + gradu.transpose(1, 2)) * n[:, None, :]).sum(dim=2)
    tauw = muhat * (force * tangf).sum(dim=1)
    cf = 2.0 * tauw
    return cp, cf, tangf


def _force_coeffs(space, cp, cf, n, tangf, ar, wmask):
    """Integrated (CL, CDp, CDsf) as wall-masked area-weighted sums
    (flow_spatial.cpp:240-310): masked sums over the given boundary faces,
    each divided by the total wall length."""
    aoa = space.pcfg.aoa
    kw = dict(dtype=cp.dtype, device=cp.device)
    wind = torch.tensor([math.cos(aoa), math.sin(aoa)], **kw)
    flownormal = torch.tensor([-math.sin(aoa), math.cos(aoa)], **kw)
    ndotw = (n * wind).sum(1)
    ndotnw = (n * flownormal).sum(1)
    tdotw = (tangf * wind).sum(1)
    w = ar * wmask
    totalarea = w.sum()
    return ((cp * ndotnw * w).sum() / totalarea,
            (cp * ndotw * w).sum() / totalarea,
            (cf * tdotw * w).sum() / totalarea)


def make_functionals(space, wall_markers):
    """The functional evaluator (mesh, u) -> (entropy, CL, CDp, CDsf) as
    0-d tensors on u's device, with no host copy of the state or the
    gradients. The wall mask is built from mesh.bc_tag inside, over all
    max(n_bfaces, 1) boundary slots, so one evaluator serves any mesh."""
    markers = sorted(int(m) for m in wall_markers)

    def fn(mesh, u):
        ent = _entropy_error(space, mesh, u)
        grads = conserved_gradients(space, mesh, u)
        nb = mesh.bc_tag.shape[0]        # == max(n_bfaces, 1)
        mk = torch.tensor(markers, dtype=mesh.bc_tag.dtype,
                          device=mesh.bc_tag.device)
        wmask = (mesh.bc_tag[:, None] == mk[None, :]).any(1)
        lelem = mesh.f_left[:nb]
        n = mesh.f_normal[:nb]
        cp, cf, tangf = _wall_cp_cf(space, grads[lelem], u[lelem], n)
        CL, CDp, CDsf = _force_coeffs(space, cp, cf, n, tangf,
                                      mesh.f_len[:nb], wmask.to(u.dtype))
        return ent, CL, CDp, CDsf

    return fn


def surface_data(space, mesh, u: torch.Tensor, wall_markers):
    """Per-wall-face (x, y, Cp, Cf) host table plus integrated (CL, CDp,
    CDsf) (flow_spatial.cpp:130-310).

    Cp = 2 (p - p_inf); Cf = 2 tau_w with tau_w from the cell-centred
    conserved-variable gradients; coefficients normalized by total wall area.
    """
    grads = conserved_gradients(space, mesh, u)          # (NC,2,4)

    tags = mesh.bc_tag.cpu().numpy()
    wall = np.isin(tags, np.asarray(list(wall_markers)))
    sel = np.flatnonzero(wall)
    if sel.size == 0:
        return None, (0.0, 0.0, 0.0)
    sel = torch.as_tensor(sel, device=u.device)

    lelem = mesh.f_left[sel]
    n = mesh.f_normal[sel]                                # (W,2) outward
    ar = mesh.f_len[sel]
    cp, cf, tangf = _wall_cp_cf(space, grads[lelem], u[lelem], n)
    Cl, Cdp, Cdsf = _force_coeffs(space, cp, cf, n, tangf, ar,
                                  torch.ones_like(ar))
    table = torch.stack([mesh.f_mid[sel, 0], mesh.f_mid[sel, 1], cp, cf],
                        dim=1).detach().cpu().numpy()
    return table, (float(Cl), float(Cdp), float(Cdsf))
