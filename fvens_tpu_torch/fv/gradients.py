"""Cell-gradient schemes: Green-Gauss and weighted least squares.

Face-parallel formulation replacing the reference's omp-atomic scatter loops
(FVENS src/spatial/agradientschemes.cpp:62-420): per-face quantities are
computed for the whole face batch, then accumulated per cell through the
static incidence maps (mesh.cell_faces / cell_fsign) — a gather-sum whose
order is fixed, not an atomic scatter.

Input `w` is the (NC, V) cell field (primitive variables for the flow
residual, flow_spatial.cpp:684-700) and `wg` the (NB, V) boundary ghost
field. Output grads: (NC, 2, V).
"""

from __future__ import annotations

import torch


def _face_states(mesh, w, wg):
    """Left/right field values for every face; ghost on the boundary prefix."""
    nb = mesh.n_bfaces
    wl = w[mesh.f_left]                     # (NF,V)
    wr = torch.cat([wg, w[mesh.f_right[nb:]]])
    return wl, wr


def green_gauss_gradients(mesh, w, wg):
    """grad_c = 1/area_c sum_f sign_cf * ut_f * n_f * len_f, where ut is the
    inverse-distance-weighted face value (agradientschemes.cpp:62-214)."""
    wl, wr = _face_states(mesh, w, wg)
    ut = mesh.f_wl[:, None] * wl + mesh.f_wr[:, None] * wr        # (NF,V)
    fx = ut * (mesh.f_normal[:, 0] * mesh.f_len)[:, None]          # (NF,V)
    fy = ut * (mesh.f_normal[:, 1] * mesh.f_len)[:, None]

    gfx = fx[mesh.cell_faces]                                      # (NC,4,V)
    gfy = fy[mesh.cell_faces]
    s = mesh.cell_fsign[..., None]                                 # (NC,4,1)
    gx = (s * gfx).sum(dim=1) * mesh.inv_area[:, None]
    gy = (s * gfy).sum(dim=1) * mesh.inv_area[:, None]
    return torch.stack([gx, gy], dim=1)                            # (NC,2,V)


def least_squares_gradients(mesh, w, wg):
    """Inverse-distance-squared weighted least squares with the precomputed
    2x2 LHS inverse (agradientschemes.cpp:218-420).

    Per face: rhs contribution w2 * dr * du with dr = rc_l - rc_r and
    du = w_l - w_r; note both adjacent cells receive the SAME contribution
    (the sign of dr and du flip together), so the accumulation weight is
    |sign| rather than sign.
    """
    wl, wr = _face_states(mesh, w, wg)
    du = wl - wr                                                   # (NF,V)
    rx = (mesh.f_w2 * mesh.f_dr[:, 0])[:, None] * du               # (NF,V)
    ry = (mesh.f_w2 * mesh.f_dr[:, 1])[:, None] * du

    gfx = rx[mesh.cell_faces]
    gfy = ry[mesh.cell_faces]
    aw = torch.abs(mesh.cell_fsign)[..., None]
    fx = (aw * gfx).sum(dim=1)                                     # (NC,V)
    fy = (aw * gfy).sum(dim=1)

    vi = mesh.wls_vinv                                             # (NC,2,2)
    gx = vi[:, 0, 0, None] * fx + vi[:, 0, 1, None] * fy
    gy = vi[:, 1, 0, None] * fx + vi[:, 1, 1, None] * fy
    return torch.stack([gx, gy], dim=1)


def zero_gradients(mesh, w, wg):
    """First-order scheme (agradientschemes.cpp:40-60)."""
    return torch.zeros((mesh.NC, 2, w.shape[-1]), dtype=w.dtype,
                       device=w.device)


GRADIENT_FUNCTIONS = {
    "NONE": zero_gradients,
    "GREENGAUSS": green_gauss_gradients,
    "LEASTSQUARES": least_squares_gradients,
}


def get_gradient_scheme(name: str):
    """Factory (reference afactory.cpp:103-165)."""
    try:
        return GRADIENT_FUNCTIONS[name.upper()]
    except KeyError:
        raise ValueError(f"unknown gradient scheme '{name}'") from None
