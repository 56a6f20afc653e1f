"""Solution reconstruction to face quadrature points, with optional limiting.

Face-parallel equivalents of the reference hierarchy (FVENS
src/spatial/areconstruction.cpp, limitedlinearreconstruction.cpp,
musclreconstruction.cpp). Cell-based limiters (WENO weights,
Barth-Jespersen, Venkatakrishnan) are computed per cell over the static
incidence maps, then applied in a single face-batch extrapolation.

All functions take the cell field w (NC,V), boundary ghost field wg (NB,V)
and cell gradients grads (NC,2,V); they return (wL, wR) face values (NF,V).
For physical boundary faces only wL is meaningful (the flux-side ghost state
is applied by the caller, flow_spatial.cpp:777-778). Every reduction over a
cell's four slots runs in the JAX package's order (min/max/sum over dim 1).
"""

from __future__ import annotations

import torch

# constants from the reference
WENO_GAMMA = 4.0        # limitedlinearreconstruction.cpp:34
WENO_EPS = 1.0e-5
MUSCL_EPS = 1e-8        # musclreconstruction.cpp:30
MUSCL_K = 1.0 / 3.0


def _extrapolate(w, grads, cells, points, rc):
    """value at `points` extrapolated from `cells`: w_c + grad_c . (x - rc_c)."""
    d = points - rc[cells]                                  # (NF,2)
    g = grads[cells]                                        # one (NF,2,V) gather
    return w[cells] + g[:, 0, :] * d[:, 0:1] + g[:, 1, :] * d[:, 1:2]


def linear_reconstruction(mesh, w, wg, grads, limiter_param=0.0):
    """Unlimited linear (areconstruction.cpp:42-105). The right state is
    evaluated at f_rpoint (= the partner face midpoint on periodic faces)."""
    return extrapolate_faces(mesh, w, grads)


def weno_limited_gradients(mesh, grads, limiter_param=20.0):
    """Per-cell WENO-weighted gradient over the compact stencil
    {cell u face-neighbours} (limitedlinearreconstruction.cpp:50-105):
    weights w_k = lambda_k / (|grad|^2 + eps)^gamma with lambda =
    limiter_param for the central stencil and 1 for neighbours; ghost
    neighbours are skipped."""
    lam = limiter_param
    gmag2 = (grads ** 2).sum(dim=1)                         # (NC,V)
    wc = lam / (gmag2 + WENO_EPS) ** WENO_GAMMA             # central weight

    nbr = torch.where(mesh.nbr_mask > 0, mesh.cell_nbrs, 0)  # clip ghost slots
    gn = grads[nbr]                                         # (NC,4,2,V)
    gn_mag2 = (gn ** 2).sum(dim=2)                          # (NC,4,V)
    wn = mesh.nbr_mask[..., None] / (gn_mag2 + WENO_EPS) ** WENO_GAMMA

    wsum = wc + wn.sum(dim=1)                               # (NC,V)
    return (wc[:, None, :] * grads
            + (wn[:, :, None, :] * gn).sum(dim=1)) / wsum[:, None, :]


def weno_reconstruction(mesh, w, wg, grads, limiter_param=20.0):
    return extrapolate_faces(
        mesh, w, weno_limited_gradients(mesh, grads, limiter_param))


def _minmax_neighbour_delta(mesh, w, wg):
    """duimin/duimax over face-neighbours incl. boundary ghosts, baseline 0
    (limitedlinearreconstruction.cpp:131-141). cell_nbrs holds NC + the
    boundary face's index on boundary slots: [w; wg] is indexed unclamped."""
    w_ext = torch.cat([w, wg], dim=0)                       # (NC+NB, V)
    du = w_ext[mesh.cell_nbrs] - w[:, None, :]              # (NC,4,V)
    valid = (torch.abs(mesh.cell_fsign) > 0)[..., None]
    du = torch.where(valid, du, 0.0)
    return du.amin(dim=1), du.amax(dim=1)                   # (NC,V) each


def _cell_face_extrapolation_deltas(mesh, w, grads):
    """diff_ik = (unlimited face value - cell value) at each of the cell's
    own faces: (NC,4,V)."""
    grf = mesh.f_mid[mesh.cell_faces]                       # (NC,4,2)
    d = grf - mesh.rc[:, None, :]                           # (NC,4,2)
    return (d[..., 0:1] * grads[:, None, 0, :]
            + d[..., 1:2] * grads[:, None, 1, :])           # (NC,4,V)


def barth_jespersen_limiter(mesh, w, wg, grads):
    """phi_c = min over faces of the BJ ratio (llr.cpp:96-155)."""
    duimin, duimax = _minmax_neighbour_delta(mesh, w, wg)
    diff = _cell_face_extrapolation_deltas(mesh, w, grads)  # (NC,4,V)
    diff_safe = torch.where(diff == 0.0, 1.0, diff)
    rpos = duimax[:, None, :] / diff_safe
    rneg = duimin[:, None, :] / diff_safe
    phi_ik = torch.where(diff > 0, torch.clamp_max(rpos, 1.0),
                         torch.where(diff < 0, torch.clamp_max(rneg, 1.0),
                                     1.0))
    valid = (torch.abs(mesh.cell_fsign) > 0)[..., None]
    phi_ik = torch.where(valid, phi_ik, 1.0)
    return phi_ik.amin(dim=1)                               # (NC,V)


def venkatakrishnan_limiter(mesh, w, wg, grads, K):
    """Venkatakrishnan with eps^2 = (K h_c)^3 (llr.cpp:181-268). With K = 0
    a cell whose deltas are all zero gives 0/0, as in the JAX package."""
    eps2 = (K * mesh.clength) ** 3                          # (NC,)
    duimin, duimax = _minmax_neighbour_delta(mesh, w, wg)
    dm = _cell_face_extrapolation_deltas(mesh, w, grads)    # (NC,4,V)
    dp = torch.where(dm < 0, duimin[:, None, :], duimax[:, None, :])
    e2 = eps2[:, None, None]
    phi_ik = ((dp * dp + 2 * dp * dm + e2)
              / (dp * dp + dp * dm + 2 * dm * dm + e2))
    valid = (torch.abs(mesh.cell_fsign) > 0)[..., None]
    phi_ik = torch.where(valid, phi_ik, 1.0)
    return phi_ik.amin(dim=1)


def _limited_linear(mesh, w, wg, grads, phi):
    """Extrapolate with per-cell limited slope phi (NC,V)."""
    return extrapolate_faces(mesh, w, grads * phi[:, None, :])


def bj_reconstruction(mesh, w, wg, grads, limiter_param=0.0):
    return _limited_linear(mesh, w, wg, grads,
                           barth_jespersen_limiter(mesh, w, wg, grads))


def venkat_reconstruction(mesh, w, wg, grads, limiter_param=20.0):
    return _limited_linear(
        mesh, w, wg, grads,
        venkatakrishnan_limiter(mesh, w, wg, grads, limiter_param))


def muscl_vanalbada_reconstruction(mesh, w, wg, grads, limiter_param=0.0):
    """MUSCL with Van Albada limiter, k = 1/3 (musclreconstruction.cpp:25-160).

    Face-based: biased difference delta = 2 grad_c . (r_j - r_i) - (u_j - u_i)
    from each side's own gradient; boundary faces use the ghost state and the
    mirrored ghost centre.
    """
    nb = mesh.n_bfaces
    ui = w[mesh.f_left]                                     # (NF,V)
    uj = torch.cat([wg, w[mesh.f_right[nb:]]])
    ri = mesh.f_rcl
    rj = mesh.f_rcr                                         # ghost centre on bdry
    dr = rj - ri                                            # (NF,2)

    gl = grads[mesh.f_left]                                 # (NF,2,V)
    gr_ = grads[mesh.f_right]
    deltam = (2.0 * (gl[:, 0, :] * dr[:, 0:1] + gl[:, 1, :] * dr[:, 1:2])
              - (uj - ui))
    deltap = (2.0 * (gr_[:, 0, :] * dr[:, 0:1] + gr_[:, 1, :] * dr[:, 1:2])
              - (uj - ui))

    duij = uj - ui
    phil = ((2.0 * deltam * duij + MUSCL_EPS)
            / (deltam ** 2 + duij ** 2 + MUSCL_EPS))
    phil = torch.clamp_min(phil, 0.0)
    phir = ((2.0 * deltap * duij + MUSCL_EPS)
            / (deltap ** 2 + duij ** 2 + MUSCL_EPS))
    phir = torch.clamp_min(phir, 0.0)

    wL = ui + phil / 4.0 * ((1.0 - MUSCL_K * phil) * deltam
                            + (1.0 + MUSCL_K * phil) * duij)
    wR = uj - phir / 4.0 * ((1.0 - MUSCL_K * phir) * deltap
                            + (1.0 + MUSCL_K * phir) * duij)
    return wL, wR


def cell_limited_gradients(mesh, w, wg, grads, name: str, limiter_param):
    """Per-cell effective reconstruction gradient for cell-based schemes;
    None for the face-based MUSCL-VanAlbada."""
    n = name.upper()
    if n in ("NONE", "LINEAR"):
        return grads
    if n == "WENO":
        return weno_limited_gradients(mesh, grads, limiter_param)
    if n == "BARTHJESPERSEN":
        return grads * barth_jespersen_limiter(mesh, w, wg, grads)[:, None, :]
    if n == "VENKATAKRISHNAN":
        return grads * venkatakrishnan_limiter(
            mesh, w, wg, grads, limiter_param)[:, None, :]
    return None


def extrapolate_faces(mesh, w, lgrad):
    """Face states from per-cell effective gradients (the shared tail of all
    cell-based reconstructions). The right state is evaluated at f_rpoint
    (= the partner face midpoint on periodic faces)."""
    wL = _extrapolate(w, lgrad, mesh.f_left, mesh.f_mid, mesh.rc)
    wR = _extrapolate(w, lgrad, mesh.f_right, mesh.f_rpoint, mesh.rc)
    return wL, wR


RECONSTRUCTION_FUNCTIONS = {
    "NONE": linear_reconstruction,       # order handled by zero gradients
    "LINEAR": linear_reconstruction,
    "WENO": weno_reconstruction,
    "BARTHJESPERSEN": bj_reconstruction,
    "VENKATAKRISHNAN": venkat_reconstruction,
    "VANALBADA": muscl_vanalbada_reconstruction,
}


def get_reconstruction(name: str):
    """Factory (reference afactory.cpp:168-249)."""
    try:
        return RECONSTRUCTION_FUNCTIONS[name.upper()]
    except KeyError:
        raise ValueError(f"unknown reconstruction '{name}'") from None
