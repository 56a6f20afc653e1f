"""The port's residual, boundary states, Roe and HLLC fluxes and slot
Jacobian against the JAX package's, at f64: on the laminar NACA0012 case
(the bench's physics: M 0.5, Re 5000, Roe, weighted least squares, LINEAR,
adiabatic wall + inflow/outflow) on naca0012_omesh(64, 16), and on the
inviscid cylinder case (M 0.38, HLLC, slip wall + far field) on
cylinder_omesh(32, 16), also with AUSM, Green-Gauss and Venkatakrishnan
(the numerics the port once refused; every flux, gradient scheme and
reconstruction is in tests/test_torch_reconstruction.py and the pair
files).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: rhs and dt to 1e-12 relative (the same arithmetic, summed in
the same slot order); Jacobian blocks to 1e-11 of the largest block entry
(forward-mode AD in two frameworks); pointwise fluxes to 1e-13.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvens_tpu.cases.casesolvers import build_space as jax_build_space
from fvens_tpu.fv import bcs as jbcs
from fvens_tpu.fv.fluxes import hllc_flux as jax_hllc_flux
from fvens_tpu.fv.fluxes import roe_flux as jax_roe_flux
from fvens_tpu.mesh import compile_mesh as jax_compile_mesh
from fvens_tpu.mesh.meshgen import cylinder_omesh, naca0012_omesh
from fvens_tpu.solver import jacobian as jjac
from fvens_tpu_torch import interop
from fvens_tpu_torch.cases.bench_case import bench_config
from fvens_tpu_torch.cases.bigmesh_case import case_config as cyl_config
from fvens_tpu_torch.cases.casesolvers import build_space
from fvens_tpu_torch.config import BC_NAMES, NumericsConfig
from fvens_tpu_torch.fv import bcs as tbcs
from fvens_tpu_torch.fv.fluxes import hllc_flux, roe_flux
from fvens_tpu_torch.mesh import compile_mesh
from fvens_tpu_torch.solver import jacobian as tjac


def _state(u, dtype=None):
    """The JAX state as the port's tensor on the CPU."""
    return interop.state_from_numpy(u, dtype, "cpu")


@functools.lru_cache(maxsize=None)
def _meshes(ni, nj):
    cfg = bench_config()
    md = naca0012_omesh(ni, nj)
    return (jax_compile_mesh(md, cfg.bcs, dtype=jnp.float64),
            compile_mesh(md, cfg.bcs, dtype=torch.float64,
                         device="cpu"))


@functools.lru_cache(maxsize=None)
def jax_space():
    """The JAX package's bench space and its residual/Jacobian, jitted once
    per test process (op-by-op dispatch would compile every op)."""
    js = jax_build_space(bench_config())
    res = jax.jit(lambda m, u: js.compute_residual(m, u, True))
    res_only = jax.jit(lambda m, u: js.compute_residual(m, u, False)[0])
    jac = jax.jit(js.assemble_jacobian)
    return js, res, res_only, jac


def _case(ni=64, nj=16, seed=0, amp=0.01):
    """(jax mesh, torch mesh, jax space, torch space, u as numpy): the bench
    physics on a small O-mesh at a free stream perturbed from a seed."""
    jm, tm = _meshes(ni, nj)
    js, ts = jax_space()[0], build_space(bench_config())
    rng = np.random.default_rng(seed)
    u = np.tile(np.asarray(js.uinf), (jm.NC, 1))
    u = u * (1.0 + amp * rng.standard_normal(u.shape))
    return jm, tm, js, ts, u


def to_jax_config(obj):
    """The JAX package's config object with every field of the port's (the
    two config modules define the same dataclasses)."""
    import fvens_tpu.config as jc
    if dataclasses.is_dataclass(obj):
        return getattr(jc, type(obj).__name__)(**{
            f.name: to_jax_config(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_jax_config(o) for o in obj)
    return obj


@functools.lru_cache(maxsize=None)
def cyl_meshes(ni, nj):
    """(jax mesh, torch mesh) of the cylinder case's O-mesh at f64."""
    cfg = cyl_config()
    md = cylinder_omesh(ni, nj, stretch=1.15 ** (20.0 / nj))
    return (jax_compile_mesh(md, cfg.bcs, dtype=jnp.float64),
            compile_mesh(md, cfg.bcs, dtype=torch.float64,
                         device="cpu"))


@functools.lru_cache(maxsize=None)
def jax_cyl_space():
    """The JAX package's cylinder-case space, residual and Jacobian."""
    js = jax_build_space(to_jax_config(cyl_config()))
    res = jax.jit(lambda m, u: js.compute_residual(m, u, True))
    jac = jax.jit(js.assemble_jacobian)
    return js, res, jac


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(a).max()
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


def test_residual_and_timesteps_match_jax():
    jm, tm, js, ts, u = _case()
    _, res, res_only, _ = jax_space()
    rj, dj = res(jm, jnp.asarray(u))
    rt, dt = ts.compute_residual(tm, _state(u), True)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-12,
                               atol=1e-12 * float(jnp.abs(rj).max()))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-12)
    r2j = res_only(jm, jnp.asarray(u))
    r2t, none = ts.compute_residual(tm, _state(u), False)
    assert none is None
    _close(r2j, r2t.numpy(), 1e-12)


def test_first_order_residual_matches_jax():
    """The first-order (starter) discretization: no gradients, no
    reconstruction, flux-side ghosts from the cell states."""
    jm, tm, _, _, u = _case(seed=5)
    js1 = jax_build_space(bench_config(), order2=False)
    ts1 = build_space(bench_config(), order2=False)
    rj, dj = jax.jit(lambda m, v: js1.compute_residual(m, v, True))(
        jm, jnp.asarray(u))
    rt, dt = ts1.compute_residual(tm, _state(u), True)
    _close(rj, rt.numpy(), 1e-12)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-12)
    r2, _ = build_space(bench_config()).compute_residual(
        tm, _state(u), True)
    assert not torch.allclose(r2, rt)          # second order differs


def test_jacobian_blocks_match_jax():
    jm, tm, js, ts, u = _case(seed=1)
    _, res, _, jac = jax_space()
    Jj = jac(jm, jnp.asarray(u))
    Jt = ts.assemble_jacobian(tm, _state(u))
    _close(Jj.D, Jt.D.numpy(), 1e-11)
    _close(Jj.N, Jt.N.numpy(), 1e-11)
    rj, dj = res(jm, jnp.asarray(u))
    Jj = jjac.add_pseudotime_term(jm, Jj, 50.0, dj)
    Jt = tjac.add_pseudotime_term(tm, Jt, 50.0,
                                  torch.from_numpy(np.asarray(dj)))
    _close(Jj.D, Jt.D.numpy(), 1e-11)


def test_jacobian_stays_f32_in_mixed_precision():
    """A f32 mesh and state give f32 blocks (torch's forward AD would
    promote 0-dim f32 intermediates to f64)."""
    jm, tm, js, ts, u = _case()
    m32 = tm.to(torch.float32)
    J = ts.assemble_jacobian(m32, _state(u, torch.float32))
    assert J.D.dtype == torch.float32 and J.N.dtype == torch.float32
    J64 = ts.assemble_jacobian(tm, _state(u))
    _close(J64.N.numpy(), J.N.double().numpy(), 1e-4)


@pytest.mark.parametrize("bc", sorted(set(BC_NAMES) - {"dirichlet"}))
def test_ghost_state_every_bc_code(bc):
    """The branch-free select over all BC codes, batched and on one face."""
    rng = np.random.default_rng(2)
    B = 64
    js, ts = jax_space()[0], build_space(bench_config())
    uinf = np.asarray(js.uinf)
    ins = uinf * (1.0 + 0.2 * rng.standard_normal((B, 4)))
    ins[:, 1:3] += 0.8 * rng.standard_normal((B, 2))   # in- and outflow
    th = rng.uniform(0, 2 * np.pi, B)
    n = np.stack([np.cos(th), np.sin(th)], 1)
    code = np.full(B, BC_NAMES[bc], np.int64)
    v0 = rng.uniform(0.5, 1.5, B) if bc == "subsonic_inflow" else \
        rng.uniform(-0.1, 0.1, B)
    v1 = rng.uniform(250.0, 350.0, B)
    partner = np.roll(ins, 3, axis=0)
    gj = jbcs.ghost_state(js.phy, jnp.asarray(ins), jnp.asarray(n),
                          jnp.asarray(code, jnp.int32), jnp.asarray(v0),
                          jnp.asarray(v1), jnp.asarray(uinf),
                          u_partner=jnp.asarray(partner))
    T = torch.from_numpy
    uinf_t = ts.uinf(torch.float64, "cpu")
    gt = tbcs.ghost_state(ts.phy, T(ins), T(n), T(code), T(v0), T(v1),
                          uinf_t, u_partner=T(partner))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-13,
                               atol=1e-13)
    A = torch.as_tensor
    g1 = tbcs.ghost_state(ts.phy, A(ins[5]), A(n[5]), A(code[5]), A(v0[5]),
                          A(v1[5]), uinf_t, u_partner=A(partner[5]))
    np.testing.assert_allclose(g1.numpy(), gt[5].numpy(), rtol=1e-15)


def test_roe_flux_matches_jax_batched_and_single():
    rng = np.random.default_rng(3)
    js, ts = jax_space()[0], build_space(bench_config())
    uinf = np.asarray(js.uinf)
    ul = uinf * (1.0 + 0.1 * rng.standard_normal((32, 4)))
    ur = uinf * (1.0 + 0.1 * rng.standard_normal((32, 4)))
    th = rng.uniform(0, 2 * np.pi, 32)
    n = np.stack([np.cos(th), np.sin(th)], 1)
    fj = jax.vmap(lambda a, b, c: jax_roe_flux(js.phy, a, b, c))(
        jnp.asarray(ul), jnp.asarray(ur), jnp.asarray(n))
    T = torch.from_numpy
    ft = roe_flux(ts.phy, T(ul), T(ur), T(n))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-13,
                               atol=1e-13)
    f0 = roe_flux(ts.phy, T(ul[0]), T(ur[0]), T(n[0]))
    np.testing.assert_allclose(f0.numpy(), ft[0].numpy(), rtol=1e-15)


def _hllc_states(B=256, seed=8):
    """Random state pairs and normals over every branch of HLLC:
    supersonic either way, subsonic either side of the contact."""
    rng = np.random.default_rng(seed)
    js = jax_cyl_space()[0]
    uinf = np.asarray(js.uinf)

    def states():
        u = uinf * (1.0 + 0.2 * rng.standard_normal((B, 4)))
        u[:, 1:3] = u[:, :1] * rng.uniform(-6.0, 6.0, (B, 2))
        u[:, 3] += 0.5 * (u[:, 1] ** 2 + u[:, 2] ** 2) / u[:, 0]
        return u
    th = rng.uniform(0, 2 * np.pi, B)
    return states(), states(), np.stack([np.cos(th), np.sin(th)], 1)


@pytest.mark.parametrize("frozen", [False, True])
def test_hllc_flux_and_jacobian_match_jax(frozen):
    """The HLLC flux and its forward-mode Jacobian (frozen wave speeds or
    not) on random states that reach all four branches, to 1e-13."""
    from torch.func import jacfwd
    ul, ur, n = _hllc_states()
    js = jax_cyl_space()[0]
    ts = build_space(cyl_config())
    fj = jax.vmap(lambda a, b, c: jax_hllc_flux(js.phy, a, b, c))(
        jnp.asarray(ul), jnp.asarray(ur), jnp.asarray(n))
    T = torch.from_numpy
    ft = hllc_flux(ts.phy, T(ul), T(ur), T(n))
    _close(fj, ft.numpy(), 1e-13)
    f0 = hllc_flux(ts.phy, T(ul[0]), T(ur[0]), T(n[0]))
    np.testing.assert_allclose(f0.numpy(), ft[0].numpy(), rtol=1e-15)

    # every one of the four branches occurs: supersonic to the right or
    # left, subsonic on either side of the contact
    def vn_c(u):
        p = ts.phy.pressure(T(u)).numpy()
        return ((u[:, 1] * n[:, 0] + u[:, 2] * n[:, 1]) / u[:, 0],
                np.sqrt(1.4 * p / u[:, 0]))
    (vl, cl), (vr, cr) = vn_c(ul), vn_c(ur)
    assert (vl - cl > 0).any() and (vr + cr < 0).any()
    assert ((vl > 0) & (vl - cl < 0)).any()
    assert ((vr < 0) & (vr + cr > 0)).any()

    Jj = jax.vmap(jax.jacfwd(lambda a, b, c: jax_hllc_flux(
        js.phy, a, b, c, frozen=frozen), argnums=(0, 1)))(
        jnp.asarray(ul), jnp.asarray(ur), jnp.asarray(n))
    jt = torch.func.vmap(jacfwd(lambda a, b, c: hllc_flux(
        ts.phy, a, b, c, frozen=frozen), argnums=(0, 1)))(T(ul), T(ur), T(n))
    for a, b in zip(Jj, jt):
        assert np.isfinite(b.numpy()).all()
        _close(a, b.numpy(), 1e-13)


def test_hllc_residual_and_jacobian_match_jax():
    """The second-order HLLC residual and dt (1e-12) and the slot Jacobian
    (1e-11) of the cylinder case on cylinder_omesh(32, 16)."""
    jm, tm = cyl_meshes(32, 16)
    js, res, jac = jax_cyl_space()
    ts = build_space(cyl_config())
    rng = np.random.default_rng(9)
    u = np.tile(np.asarray(js.uinf), (jm.NC, 1))
    u = u * (1.0 + 0.01 * rng.standard_normal(u.shape))
    rj, dj = res(jm, jnp.asarray(u))
    rt, dt = ts.compute_residual(tm, _state(u), True)
    _close(rj, rt.numpy(), 1e-12)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-12)
    Jj = jac(jm, jnp.asarray(u))
    Jt = ts.assemble_jacobian(tm, _state(u))
    _close(Jj.D, Jt.D.numpy(), 1e-11)
    _close(Jj.N, Jt.N.numpy(), 1e-11)


@pytest.mark.parametrize("numerics", [
    dict(flux="AUSM"), dict(gradient="GREENGAUSS"),
    dict(reconstruction="VENKATAKRISHNAN")])
def test_unported_numerics_refused(numerics):
    """The numerics the port refused before the schemes were ported (AUSM,
    Green-Gauss, Venkatakrishnan at its default K = 20) now build, and
    their residual (1e-12) and slot Jacobian (1e-11) on the cylinder case's
    cylinder_omesh(32, 16) match the JAX package's."""
    base = dict(flux="ROE", gradient="LEASTSQUARES",
                reconstruction="LINEAR", order2=True)
    base.update(numerics)
    cfg = dataclasses.replace(cyl_config(), numerics=NumericsConfig(**base))
    jm, tm = cyl_meshes(32, 16)
    js = jax_build_space(to_jax_config(cfg))
    ts = build_space(cfg)
    rng = np.random.default_rng(10)
    u = np.tile(np.asarray(js.uinf), (jm.NC, 1))
    u = u * (1.0 + 0.01 * rng.standard_normal(u.shape))
    rj, dj = js.compute_residual(jm, jnp.asarray(u), True)
    rt, dt = ts.compute_residual(tm, _state(u), True)
    _close(rj, rt.numpy(), 1e-12)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-12)
    Jj = jax.jit(js.assemble_jacobian)(jm, jnp.asarray(u))
    Jt = ts.assemble_jacobian(tm, _state(u))
    _close(Jj.D, Jt.D.numpy(), 1e-11)
    _close(Jj.N, Jt.N.numpy(), 1e-11)
