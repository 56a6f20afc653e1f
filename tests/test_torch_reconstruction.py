"""The port's gradient schemes, limiters and reconstructions against the
JAX package's, at f64, and the limited residual on four meshes. The
residual and slot Jacobian of every (flux, reconstruction) pair are
tests/test_torch_scheme_pairs.py and test_torch_jacobian_pairs.py, which
share this file's meshes and states.

Meshes: cylinder_omesh(24, 10) (slip wall + far field), the triangulated
gaussian_channel(24, 9) (walls + inflow/outflow), naca0012_omesh(32, 16)
(slip wall + far field at M 0.8, AoA 1.25) and a 12x12 fully periodic box.
States are the free stream times (1 + 0.01 N(0,1)) from
numpy.random.default_rng, so every limiter is active somewhere. Tolerance:
1e-12 of the largest entry of the compared array (the same arithmetic,
reduced in the same slot order). Venkatakrishnan runs at K = 20, and at
K = 0, where both packages give NaN at the same cells (ROADMAP queue 3).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvens_tpu.cases.casesolvers import build_space as jax_build_space
from fvens_tpu.fv import gradients as jgrad
from fvens_tpu.fv import reconstruction as jrec
from fvens_tpu.mesh import compile_mesh as jax_compile_mesh
from fvens_tpu.mesh.meshgen import (_grid_mesh, cylinder_omesh,
                                    gaussian_channel, naca0012_omesh)
from fvens_tpu_torch import interop
from fvens_tpu_torch.cases.casesolvers import build_space
from fvens_tpu_torch.config import (RECONSTRUCTIONS, BCSpec, FlowCaseConfig,
                                    NumericsConfig, PhysicsConfig)
from fvens_tpu_torch.fv import gradients as tgrad
from fvens_tpu_torch.fv import reconstruction as trec
from fvens_tpu_torch.mesh import compile_mesh

from test_torch_residual import to_jax_config


def _box():
    xs = np.linspace(0.0, 10.0, 13)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    return _grid_mesh(X, Y, {"imin": 7, "imax": 7, "jmin": 8, "jmax": 8})


# name: (mesh, BCs, Mach, angle of attack)
WALL_FAR = (BCSpec(marker=2, type="slipwall"),
            BCSpec(marker=4, type="farfield"))
MESHES = {
    "cylinder": (lambda: cylinder_omesh(24, 10), WALL_FAR, 0.38, 0.0),
    "channel": (lambda: gaussian_channel(24, 9, tri=True),
                (BCSpec(marker=2, type="slipwall"),
                 BCSpec(marker=3, type="inflowoutflow"),
                 BCSpec(marker=4, type="inflowoutflow")), 0.5, 0.0),
    "naca": (lambda: naca0012_omesh(32, 16), WALL_FAR, 0.8, 1.25),
    "box": (_box, (BCSpec(marker=7, type="periodic", periodic_axis=0),
                   BCSpec(marker=8, type="periodic", periodic_axis=1)),
            0.5, 0.0),
}
LIMITER_PARAM = {"WENO": 0.0, "VENKATAKRISHNAN": 20.0}


def config(mesh="cylinder", **numerics):
    _, bcs, mach, aoa = MESHES[mesh]
    num = dict(flux="HLLC", gradient="LEASTSQUARES", reconstruction="LINEAR",
               order2=True)
    num.update(numerics)
    return FlowCaseConfig(physics=PhysicsConfig(Minf=mach, aoa_deg=aoa,
                                                viscous=False),
                          numerics=NumericsConfig(**num), bcs=list(bcs))


@functools.lru_cache(maxsize=None)
def meshes(name):
    """(jax mesh, torch mesh, state u as numpy) of one of MESHES."""
    make, bcs = MESHES[name][:2]
    md = make()
    jm = jax_compile_mesh(md, list(bcs), dtype=jnp.float64)
    tm = compile_mesh(md, list(bcs), dtype=torch.float64, device="cpu")
    js = jax_build_space(to_jax_config(config(name)))
    rng = np.random.default_rng(6)
    u = np.tile(np.asarray(js.uinf), (jm.NC, 1))
    return jm, tm, u * (1.0 + 0.01 * rng.standard_normal(u.shape))


@functools.lru_cache(maxsize=None)
def primitives(name):
    """The primitive cell field and ghosts both residuals reconstruct, as
    numpy: (w, wg)."""
    jm, _, u = meshes(name)
    js = jax_build_space(to_jax_config(config(name)))
    uj = jnp.asarray(u)
    ug = js.ghost_states(jm, uj)
    return (np.asarray(js.phy.primitive_from_conserved(uj)),
            np.asarray(js.phy.primitive_from_conserved(ug)))


def _t(a):
    return interop.state_from_numpy(np.asarray(a), None, "cpu")


def _close(want, got, tol):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    assert np.array_equal(np.isnan(want), np.isnan(got))
    scale = max(float(np.nanmax(np.abs(want))), 1e-300)
    err = float(np.nanmax(np.abs(want - got), initial=0.0))
    assert err <= tol * scale, f"{err} > {tol} * {scale}"


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("scheme", ["GREENGAUSS", "LEASTSQUARES"])
def test_gradients_match_jax(mesh, scheme):
    jm, tm, _ = meshes(mesh)
    w, wg = primitives(mesh)
    want = jgrad.get_gradient_scheme(scheme)(jm, jnp.asarray(w),
                                             jnp.asarray(wg))
    got = tgrad.get_gradient_scheme(scheme)(tm, _t(w), _t(wg))
    _close(want, got.numpy(), 1e-12)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("recon", RECONSTRUCTIONS)
def test_limited_gradients_and_face_states_match_jax(mesh, recon):
    """cell_limited_gradients (None for VANALBADA in both) and the face
    states of the reconstruction function, from least-squares gradients."""
    jm, tm, _ = meshes(mesh)
    w, wg = primitives(mesh)
    K = LIMITER_PARAM.get(recon, 0.0)
    g = np.asarray(jgrad.least_squares_gradients(jm, jnp.asarray(w),
                                                 jnp.asarray(wg)))
    jargs = (jm, jnp.asarray(w), jnp.asarray(wg), jnp.asarray(g))
    targs = (tm, _t(w), _t(wg), _t(g))
    want = jrec.cell_limited_gradients(*jargs, recon, K)
    got = trec.cell_limited_gradients(*targs, recon, K)
    assert (want is None) == (got is None) == (recon == "VANALBADA")
    if want is not None:
        _close(want, got.numpy(), 1e-12)
    wl, wr = jrec.get_reconstruction(recon)(*jargs, K)
    tl, tr = trec.get_reconstruction(recon)(*targs, K)
    _close(wl, tl.numpy(), 1e-12)
    _close(wr, tr.numpy(), 1e-12)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_limiters_match_jax(mesh):
    """The per-cell Barth-Jespersen and Venkatakrishnan factors and the
    neighbour min/max deltas they share, ghosts included."""
    jm, tm, _ = meshes(mesh)
    w, wg = primitives(mesh)
    g = np.asarray(jgrad.least_squares_gradients(jm, jnp.asarray(w),
                                                 jnp.asarray(wg)))
    jargs = (jm, jnp.asarray(w), jnp.asarray(wg), jnp.asarray(g))
    targs = (tm, _t(w), _t(wg), _t(g))
    for a, b in zip(jrec._minmax_neighbour_delta(*jargs[:3]),
                    trec._minmax_neighbour_delta(*targs[:3])):
        _close(a, b.numpy(), 1e-12)
    phi = jrec.barth_jespersen_limiter(*jargs)
    # active somewhere; on quads it can fall below 0 (ROADMAP queue 3)
    assert float(phi.min()) < 1.0
    _close(phi, trec.barth_jespersen_limiter(*targs).numpy(), 1e-12)
    _close(jrec.venkatakrishnan_limiter(*jargs, 20.0),
           trec.venkatakrishnan_limiter(*targs, 20.0).numpy(), 1e-12)


@functools.lru_cache(maxsize=None)
def _jax_residual(mesh, flux, recon, gradient="LEASTSQUARES"):
    jm, _, u = meshes(mesh)
    cfg = config(mesh, flux=flux, reconstruction=recon, gradient=gradient,
                 limiter_param=LIMITER_PARAM.get(recon, 0.0))
    js = jax_build_space(to_jax_config(cfg))
    rhs, dt = js.compute_residual(jm, jnp.asarray(u), True)
    return np.asarray(rhs), np.asarray(dt)


@pytest.mark.parametrize("mesh", ["cylinder", "channel", "box"])
@pytest.mark.parametrize("recon", ["WENO", "VENKATAKRISHNAN", "VANALBADA"])
def test_limited_residual_on_other_meshes(mesh, recon):
    """The limited residual with Green-Gauss and least-squares gradients
    on the wall/far-field, inflow/outflow and periodic meshes."""
    _, tm, u = meshes(mesh)
    for gradient in ("GREENGAUSS", "LEASTSQUARES"):
        rj, dj = _jax_residual(mesh, "ROE", recon, gradient)
        ts = build_space(config(mesh, flux="ROE", reconstruction=recon,
                                gradient=gradient,
                                limiter_param=LIMITER_PARAM.get(recon, 0.0)))
        rt, dt = ts.compute_residual(tm, _t(u), True)
        _close(rj, rt.numpy(), 1e-12)
        _close(dj, dt.numpy(), 1e-12)


def test_venkatakrishnan_k0_nan_at_the_same_cells():
    """K = 0 makes eps^2 = 0: a free-stream cell with all deltas zero gives
    0/0 in both packages, at the same cells (the control-file parser always
    sets limiter_param 0)."""
    jm, tm, _ = meshes("cylinder")
    js = jax_build_space(to_jax_config(config()))
    u = np.tile(np.asarray(js.uinf), (jm.NC, 1))
    rng = np.random.default_rng(3)
    half = (jm.n_cells // 2, 4)
    u[: half[0]] += 0.001 * rng.standard_normal(half)
    cfg = config(reconstruction="VENKATAKRISHNAN", limiter_param=0.0)
    rj, _ = jax_build_space(to_jax_config(cfg)).compute_residual(
        jm, jnp.asarray(u), True)
    rt, _ = build_space(cfg).compute_residual(tm, _t(u), True)
    rj = np.asarray(rj)
    assert np.isnan(rj).any() and not np.isnan(rj).all()
    _close(rj, rt.numpy(), 1e-12)
    cfg20 = config(reconstruction="VENKATAKRISHNAN", limiter_param=20.0)
    assert torch.isfinite(build_space(cfg20).compute_residual(
        tm, _t(u), True)[0]).all()
