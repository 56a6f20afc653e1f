"""Scalar diffusion (Laplacian) spatial discretization.

The reference's DiffusionMA (FVENS src/spatial/diffusion.cpp:74-250): constant
diffusivity, Dirichlet boundaries via mirrored ghosts, source-term callback,
modified-average face gradients. It runs the whole solver stack on a trivial
PDE with V = 1 blocks; the heat-equation convergence tests use it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..solver.linear import BlockJacobian
from .bcs import scalar_ghost_state
from .gradients import get_gradient_scheme
from .viscous import modified_average_gradient


@dataclasses.dataclass(frozen=True)
class DiffusionFV:
    """nvars=1 spatial discretization with the interface the steady solvers
    use (compute_residual -> (rhs, dt), assemble_jacobian)."""
    diffusivity: float = 1.0
    # source(xy (NC,2) tensor) -> (NC,1) tensor, or None
    source: Optional[Callable] = None
    gradient: str = "LEASTSQUARES"
    phy = None                             # no gas physics

    def compute_residual(self, mesh, u, gettimesteps: bool = True):
        nb = mesh.n_bfaces
        nu = self.diffusivity

        ins = u[mesh.f_left[:nb]]
        ug = scalar_ghost_state(ins, mesh.bc_code, mesh.bc_v0)

        grads = get_gradient_scheme(self.gradient)(mesh, u, ug)   # (NC,2,1)

        ul = u[mesh.f_left]
        ur = torch.cat([ug, u[mesh.f_right[nb:]]])
        gl = grads[mesh.f_left]
        # the boundary uses the left cell's gradient twice
        gr_ = torch.cat([gl[:nb], grads[mesh.f_right[nb:]]])
        fgrad = modified_average_gradient(mesh.f_dr_unit, mesh.f_dist,
                                          ul, ur, gl, gr_)        # (NF,2,1)

        # flux = -nu * (grad . n) * len  (diffusion.cpp:96-106)
        gn = (fgrad * mesh.f_normal[:, :, None]).sum(dim=1)       # (NF,1)
        fluxlen = -nu * gn * mesh.f_len[:, None]

        g = fluxlen[mesh.cell_faces]                              # (NC,4,1)
        rhs = -(mesh.cell_fsign[..., None] * g).sum(dim=1)

        if self.source is not None:
            rhs = rhs + self.source(mesh.rc) * mesh.area[:, None]
        rhs = rhs * mesh.cell_mask[:, None]

        dt = None
        if gettimesteps:
            # dt = h^2 / nu with h = max face length of the cell
            # (diffusion.cpp:22-31, 239)
            h = (mesh.f_len[mesh.cell_faces]
                 * (torch.abs(mesh.cell_fsign) > 0)).amax(dim=1)
            h = torch.clamp_min(h, 1e-300)
            dt = h * h / nu
        return rhs, dt

    def assemble_jacobian(self, mesh, u):
        """Analytic 1x1 slot blocks of the thin-layer flux (the reference's
        compute_local_jacobian_*, diffusion.cpp:253-300)."""
        nu = self.diffusivity

        # F_ck = -nu (u_nbr - u_c)/dist (dr_unit . n) len  (slot orientation)
        fc = (-nu / mesh.slot_dist
              * (mesh.slot_dr_unit * mesh.slot_normal).sum(dim=-1)
              * mesh.slot_len)                           # (NC,4)
        L = -fc                                          # dF/du_c
        N = fc * mesh.nbr_mask                           # dF/du_nbr
        # Dirichlet boundary slots: ghost = 2b - u_c -> dF/du_c = -2 fc
        is_b = mesh.slot_bc_code >= 0
        L = torch.where(is_b, -2.0 * fc, L)
        D = L.sum(dim=1)[:, None, None]
        D = D + (1.0 - mesh.cell_mask)[:, None, None]
        return BlockJacobian(D=D, N=N[..., None, None])
