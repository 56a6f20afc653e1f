"""The port's output functionals and tables against the JAX package's, at
f64: surface_data (x, y, Cp, Cf and CL, CDp, CDsf), make_functionals
(entropy, CL, CDp, CDsf), conserved_gradients, volume_data and point_data,
on a free stream perturbed from a seed (numpy default_rng):

  - the laminar NACA0012 (the bench physics: M 0.5, Re 5000, Roe, weighted
    least squares, adiabatic wall on marker 2) on naca0012_omesh(64, 16),
    where Cf and CDsf are not zero;
  - the inviscid cylinder of cases/ctrl/cylinder.ctrl (M 0.38, HLLC, slip
    wall on marker 2) on cylinder_omesh(24, 10): the viscosity enters Cf
    for Euler flow too, as in the JAX package;
  - both in their first-order (starter) form, where the wall gradients and
    so Cf and CDsf are zero.

Tolerance: 1e-12 of the largest magnitude of each compared quantity (the
same arithmetic, summed in the same order: mask, sum, divide by the total
wall length).
"""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvens_tpu import output as jout
from fvens_tpu.cases.casesolvers import build_space as jax_build_space
from fvens_tpu.mesh import compile_mesh as jax_compile_mesh
from fvens_tpu.mesh import meshgen as jgen
from fvens_tpu_torch import output as tout
from fvens_tpu_torch.cases.bench_case import bench_config
from fvens_tpu_torch.cases.casesolvers import build_space
from fvens_tpu_torch.io_config import parse_control_file
from fvens_tpu_torch.mesh import compile_mesh
from fvens_tpu_torch.mesh import meshgen as tgen

from test_torch_residual import to_jax_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTRL = os.path.join(ROOT, "fvens_tpu_torch", "cases", "ctrl",
                    "cylinder.ctrl")
TOL = 1e-12


def _naca():
    cfg = dataclasses.replace(bench_config(), wall_markers=(2,))
    return cfg, lambda g: g.naca0012_omesh(64, 16)


def _cylinder():
    return (parse_control_file(CTRL),
            lambda g: g.cylinder_omesh(24, 10, stretch=1.15 ** 2))


CASES = {"naca0012 viscous": _naca, "cylinder inviscid": _cylinder}


@functools.lru_cache(maxsize=None)
def _case(name, order2=True, seed=0, amp=0.01):
    """(cfg, jax mesh, torch mesh, jax space, torch space, u as numpy, the
    port's MeshData) at a free stream perturbed from a seed."""
    cfg, make = CASES[name]()
    jm = jax_compile_mesh(make(jgen), cfg.bcs, dtype=jnp.float64)
    md = make(tgen)
    tm = compile_mesh(md, cfg.bcs, dtype=torch.float64, device="cpu")
    js = jax_build_space(to_jax_config(cfg), order2=order2)
    ts = build_space(cfg, order2=order2)
    rng = np.random.default_rng(seed)
    u = np.tile(np.asarray(js.uinf), (jm.NC, 1))
    u = u * (1.0 + amp * rng.standard_normal(u.shape))
    return cfg, jm, tm, js, ts, u, md


def _close(got, want, what):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize("order2", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_surface_data_matches_jax(name, order2):
    cfg, jm, tm, js, ts, u, _ = _case(name, order2)
    jt, jc = jout.surface_data(js, jm, jnp.asarray(u), cfg.wall_markers)
    tt, tc = tout.surface_data(ts, tm, torch.from_numpy(u), cfg.wall_markers)
    assert isinstance(tt, np.ndarray) and tt.shape[1] == 4
    _close(tt, jt, "x y Cp Cf")
    _close(tc, jc, "CL CDp CDsf")
    if not order2:
        # first order: no wall gradients, so no skin friction
        assert tc[2] == 0.0 and not tt[:, 3].any()
    else:
        assert tc[2] != 0.0          # Cf of Euler flow too, as in JAX


@pytest.mark.parametrize("order2", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_make_functionals_matches_jax(name, order2):
    cfg, jm, tm, js, ts, u, _ = _case(name, order2)
    want = [float(x) for x in jout.make_functionals(js, cfg.wall_markers)(
        jm, jnp.asarray(u))]
    fn = tout.make_functionals(ts, cfg.wall_markers)
    got = fn(tm, torch.from_numpy(u))
    assert all(isinstance(x, torch.Tensor) and x.dim() == 0 for x in got)
    got = [float(x) for x in got]
    for k, g, w in zip(("entropy", "CL", "CDp", "CDsf"), got, want):
        assert abs(g - w) <= TOL * max(abs(w), 1e-3), k
    # the device evaluator and the host table give the same coefficients
    _, coeffs = tout.surface_data(ts, tm, torch.from_numpy(u),
                                  cfg.wall_markers)
    _close(got[1:], coeffs, "make_functionals vs surface_data")
    assert got[0] == tout.entropy_error(ts, tm, torch.from_numpy(u))


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_and_tables_match_jax(name):
    cfg, jm, tm, js, ts, u, md = _case(name)
    _close(tout.conserved_gradients(ts, tm, torch.from_numpy(u)).numpy(),
           jout.conserved_gradients(js, jm, jnp.asarray(u)),
           "conserved gradients")
    tv = tout.volume_data(ts, tm, torch.from_numpy(u))
    jv = jout.volume_data(js, jm, jnp.asarray(u))
    assert tv.shape == (tm.n_cells, 8)
    for k in range(8):
        _close(tv[:, k], jv[:, k], f"volume column {k}")
    for k in range(8):
        _close(tout.point_data(md, tv[:, k:k + 1]),
               jout.point_data(md, jv[:, k:k + 1]), f"point column {k}")


def test_functionals_device_and_missing_wall():
    """make_functionals returns tensors on u's device and dtype, with the
    wall mask built inside from bc_tag: no wall marker gives 0/0."""
    cfg, jm, tm, js, ts, u, _ = _case("cylinder inviscid")
    ent, cl, cdp, cdsf = tout.make_functionals(ts, (99,))(
        tm, torch.from_numpy(u))
    assert ent.dtype == torch.float64 and ent.device == tm.device
    assert np.isfinite(float(ent))
    assert all(np.isnan(float(x)) for x in (cl, cdp, cdsf))
    assert tout.surface_data(ts, tm, torch.from_numpy(u), (99,)) \
        == (None, (0.0, 0.0, 0.0))
    # the boundary fields are padded as the JAX package pads them
    nb = max(tm.n_bfaces, 1)
    assert tm.bc_tag.shape[0] == nb == jm.bc_tag.shape[0]
    assert tm.f_left.shape[0] >= nb and tm.f_len.shape[0] >= nb
