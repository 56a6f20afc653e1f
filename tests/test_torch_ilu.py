"""The fixed-point block ILU0 (solver/ilu.py) against the JAX package's, on
the CPU at f64:

  - ilu_structure, bit for bit, on O-meshes, a triangulated square and a
    triangulated cylinder;
  - ilu_factorize's L, Ud, Udinv and Us, and make_ilu_apply (through
    make_preconditioner(kind="ilu0")), to 1e-12 of the largest entry, on
    seeded Jacobians and on a real implicit-step Jacobian of
    cylinder_omesh(24, 10) (first-order Roe at CFL 50, the JAX package's
    own test system, tests/test_solvers.py);
  - the JAX package's own checks (tests/test_solvers.py:287-360) on the
    port: with enough sweeps the fixed point is the exact ILU0 (L U = A on
    the pattern), and many Neumann sweeps give the dense triangular solve.

The CUDA-tensor runs are held to these CPU runs in
tests/test_torch_options_gpu.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvens_tpu.solver.ilu as jilu
import fvens_tpu.solver.linear as jlinear
from fvens_tpu_torch import interop
from fvens_tpu_torch.solver import ilu as tilu
from fvens_tpu_torch.solver import linear

from test_torch_gather import MESHES, _jacobian, _meshes

TOL = 1e-12


@functools.lru_cache(maxsize=None)
def real_system():
    """(D, N, rhs as NumPy): the implicit-step system of the JAX package's
    ILU tests, first-order Roe on cylinder_omesh(24, 10) at free stream,
    CFL 50."""
    from fvens_tpu.solver import jacobian as jacmod
    from test_solvers import make_space
    jm, _ = _meshes("cylinder_omesh(24, 10)")
    space = make_space(order2=False)
    u = jnp.tile(space.uinf, (jm.NC, 1)).astype(jnp.float64)
    rhs, dt = space.compute_residual(jm, u, True)
    jac = jacmod.assemble_jacobian(space, jm, u)
    jac = jacmod.add_pseudotime_term(jm, jac, 50.0, dt)
    return np.asarray(jac.D), np.asarray(jac.N), np.asarray(rhs)


def _systems(name):
    """(JAX mesh, port mesh, D, N) of a named mesh (seeded Jacobian) or of
    "real" (real_system on cylinder_omesh(24, 10))."""
    if name == "real":
        return _meshes("cylinder_omesh(24, 10)") + real_system()[:2]
    jm, tm = _meshes(name)
    return (jm, tm) + _jacobian(jm, seed=3)


SYSTEMS = list(MESHES) + ["real"]


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("name", SYSTEMS)
def test_ilu_structure_matches_jax(name):
    jm, tm, _, _ = _systems(name)
    want = jilu.ilu_structure(jm)
    got = tilu.ilu_structure(tm)
    for field in want._fields:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert np.array_equal(g, w.astype(g.dtype)), field
        assert g.shape == w.shape, field


@pytest.mark.parametrize("sweeps", [0, 4, 12])
@pytest.mark.parametrize("name", SYSTEMS)
def test_ilu_factors_match_jax(name, sweeps):
    jm, tm, D, N = _systems(name)
    want = jilu.ilu_factorize(
        jm, jlinear.BlockJacobian(jnp.asarray(D), jnp.asarray(N)),
        jilu.ilu_structure(jm), sweeps=sweeps)
    got = tilu.ilu_factorize(tm, interop.jacobian_from_numpy(D, N,
                                                             device="cpu"),
                             tilu.ilu_structure(tm), sweeps=sweeps)
    for w, g, what in zip(want, got, ("L", "Ud", "Udinv", "Us")):
        assert _close(g, w), what


@pytest.mark.parametrize("setup,sweeps", [(4, 3), (1, 1), (8, 6)])
@pytest.mark.parametrize("name", SYSTEMS)
def test_ilu_apply_matches_jax(name, setup, sweeps):
    jm, tm, D, N = _systems(name)
    v = np.random.default_rng(5).standard_normal((jm.NC, 4))
    want = jlinear.make_preconditioner(
        jm, jlinear.BlockJacobian(jnp.asarray(D), jnp.asarray(N)), "ilu0",
        sweeps, ilu=jilu.ilu_structure(jm), ilu_setup=setup)(jnp.asarray(v))
    pc = linear.make_preconditioner(
        tm, interop.jacobian_from_numpy(D, N, device="cpu"), "ilu0", sweeps,
        ilu=tilu.ilu_structure(tm), ilu_setup=setup)
    assert _close(pc(torch.from_numpy(v)), want)


def test_ilu0_needs_its_structure():
    jm, tm, D, N = _systems("cylinder_omesh(24, 10)")
    with pytest.raises(ValueError, match="ILUStructure"):
        linear.make_preconditioner(
            tm, interop.jacobian_from_numpy(D, N, device="cpu"), "ilu0")


def _dense_from_slots(tm, D, N):
    """Dense (NC*V, NC*V) matrix from slot-block storage."""
    D, N = np.asarray(D), np.asarray(N)
    NC, V = D.shape[0], D.shape[-1]
    nbrs = tm.cell_nbrs.numpy()
    mask = tm.nbr_mask.numpy() > 0
    A = np.zeros((NC * V, NC * V))
    for c in range(NC):
        A[c * V:(c + 1) * V, c * V:(c + 1) * V] = D[c]
        for k in range(nbrs.shape[1]):
            if mask[c, k]:
                j = nbrs[c, k]
                A[c * V:(c + 1) * V, j * V:(j + 1) * V] += N[c, k]
    return A


def test_ilu0_exact_fixed_point():
    """tests/test_solvers.py:test_ilu0_exact_fixed_point on the port: with
    enough Chow-Patel sweeps the fixed point is the exact block ILU0, so
    L U equals A on the sparsity pattern."""
    jm, tm, D, N = _systems("real")
    jac = interop.jacobian_from_numpy(D, N, device="cpu")
    L, Ud, _, Us = tilu.ilu_factorize(tm, jac, tilu.ilu_structure(tm),
                                      sweeps=80)
    NC, V = D.shape[0], D.shape[-1]
    A = _dense_from_slots(tm, D, N)
    M = (_dense_from_slots(tm, np.zeros_like(D), L) + np.eye(NC * V)) \
        @ _dense_from_slots(tm, Ud, Us)
    pattern = _dense_from_slots(tm, np.ones_like(D), np.ones_like(N)) != 0
    assert np.abs(M - A)[pattern].max() <= 1e-9 * np.abs(D).max()
    # off the pattern M holds the dropped fill, which is not zero
    assert np.abs(M[~pattern]).max() > 0


def test_ilu0_apply_matches_dense_triangular_solve():
    """tests/test_solvers.py:test_ilu0_apply_matches_dense_triangular_solve
    on the port: many truncated-Neumann sweeps solve (L U) z = v."""
    jm, tm, D, N = _systems("real")
    rhs = real_system()[2]
    jac = interop.jacobian_from_numpy(D, N, device="cpu")
    L, Ud, Udinv, Us = tilu.ilu_factorize(tm, jac, tilu.ilu_structure(tm),
                                          sweeps=80)
    z = tilu.make_ilu_apply(tm, L, Udinv, Us, sweeps=120)(
        torch.from_numpy(rhs.copy())).numpy()
    NC, V = D.shape[0], D.shape[-1]
    M = (_dense_from_slots(tm, np.zeros_like(D), L) + np.eye(NC * V)) \
        @ _dense_from_slots(tm, Ud, Us)
    zd = np.linalg.solve(M, rhs.reshape(-1)).reshape(NC, V)
    np.testing.assert_allclose(z, zd, rtol=1e-6, atol=1e-8)
