"""The port's seven inviscid fluxes against the JAX package's, pointwise,
and the twins of tests/test_fluxes.py's invariants.

1,000 seeded state pairs (numpy.random.default_rng) at normal Mach numbers
in [-3, 3] on either side, so every branch of Van Leer's, AUSM's and AUSM+'s
selects, HLL's and HLLC's wave-speed cases and the Roe entropy fix is taken,
plus pairs at the measure-zero points a symmetric mesh reaches: a zero
normal velocity and a mirrored slip-wall pair. Values to 1e-13 and the
forward-mode Jacobians (torch.func.jacfwd against jax.jacfwd, CONSISTENT
and FROZEN: .detach() against stop_gradient) to 1e-12, both relative to the
largest entry of each flux's array.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvens_tpu.fv import fluxes as jf
from fvens_tpu.physics import GasPhysics as JaxGas
from fvens_tpu_torch import config as C
from fvens_tpu_torch.fv import bcs
from fvens_tpu_torch.fv import fluxes as tf
from fvens_tpu_torch.physics.gas import GasPhysics

ARGS = dict(g=1.4, Minf=0.5, Tinf=288.15, Reinf=5000.0, Pr=0.72)
PHY, JPHY = GasPhysics(**ARGS), JaxGas(**ARGS)
ALL_FLUXES = sorted(tf.FLUX_FUNCTIONS)


def _states(rng, n, mach=(-3.0, 3.0)):
    g = ARGS["g"]
    rho = rng.uniform(0.5, 2.0, n)
    p = rng.uniform(0.3, 3.0, n)
    c = np.sqrt(g * p / rho)
    m = rng.uniform(*mach, n)
    th = rng.uniform(0.0, 2.0 * np.pi, n)
    vx, vy = m * c * np.cos(th), m * c * np.sin(th)
    E = p / (g - 1.0) + 0.5 * rho * (vx * vx + vy * vy)
    return np.stack([rho, rho * vx, rho * vy, E], axis=1)


def _pairs():
    """(ul, ur, n) as numpy: 1,000 random pairs, then zero-normal-velocity
    pairs (vy = 0 across n = (0, 1)) and mirrored slip-wall pairs."""
    rng = np.random.default_rng(11)
    ul, ur = _states(rng, 1000), _states(rng, 1000)
    a = rng.uniform(0.0, 2.0 * np.pi, 1000)
    n = np.stack([np.cos(a), np.sin(a)], axis=1)
    z = _states(rng, 20)
    z[:, 2] = 0.0
    zn = np.tile([0.0, 1.0], (20, 1))
    m = _states(rng, 20, (-0.9, 0.9))
    mn = np.tile([1.0, 0.0], (20, 1))
    mirror = m * [1.0, -1.0, 1.0, 1.0]          # vn -> -vn across (1, 0)
    return (np.concatenate([ul, z, m]), np.concatenate([ur, z[::-1], mirror]),
            np.concatenate([n, zn, mn]))


UL, UR, NN = _pairs()


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _close(want, got, tol):
    want, got = np.asarray(want), np.asarray(got)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    err = float(np.abs(want - got).max())
    assert err <= tol * float(np.abs(want).max()), err


def test_states_take_every_branch():
    """Sub- and supersonic normal Mach numbers of either sign on both
    sides, HLL/HLLC in each of their wave-speed cases."""
    _, _, vn, _, _, _, c = tf._vars(PHY, _t(UL), _t(NN))
    M = (vn / c).numpy()
    assert (M < -1).any() and (M > 1).any()
    assert ((M > -1) & (M < 0)).any() and ((M > 0) & (M < 1)).any()
    assert (M == 0).any()
    *_, sl, sr = tf._einfeldt_speeds(PHY, _t(UL), _t(UR), _t(NN))
    sl, sr = sl.numpy(), sr.numpy()
    assert (sl > 0).any() and (sr < 0).any() and ((sl < 0) & (sr > 0)).any()


@pytest.mark.parametrize("name", ALL_FLUXES)
def test_flux_values_match_jax(name):
    fj = jf.FLUX_FUNCTIONS[name]
    want = jax.vmap(lambda a, b, n: fj(JPHY, a, b, n))(
        jnp.asarray(UL), jnp.asarray(UR), jnp.asarray(NN))
    got = tf.FLUX_FUNCTIONS[name](PHY, _t(UL), _t(UR), _t(NN))
    _close(want, got.numpy(), 1e-13)


@pytest.mark.parametrize("name", ALL_FLUXES)
@pytest.mark.parametrize("frozen", [False, True])
def test_flux_jacobians_match_jax(name, frozen):
    """d flux / d (ul, ur) by forward-mode AD in both frameworks."""
    fj, ft = jf.FLUX_FUNCTIONS[name], tf.FLUX_FUNCTIONS[name]
    want = jax.vmap(jax.jacfwd(
        lambda a, b, n: fj(JPHY, a, b, n, frozen=frozen), argnums=(0, 1)))(
        jnp.asarray(UL), jnp.asarray(UR), jnp.asarray(NN))
    got = torch.func.vmap(torch.func.jacfwd(
        lambda a, b, n: ft(PHY, a, b, n, frozen=frozen), argnums=(0, 1)))(
        _t(UL), _t(UR), _t(NN))
    for w, g in zip(want, got):
        _close(w, g.numpy(), 1e-12)


# the invariants of tests/test_fluxes.py, on the port's fluxes
U = _t([1.05, 0.3, -0.2, 2.1])
N = _t([np.cos(0.3), np.sin(0.3)])
UR2 = _t([0.9, -0.1, 0.25, 2.4])


@pytest.mark.parametrize("name", ALL_FLUXES)
def test_flux_consistency(name):
    f = tf.FLUX_FUNCTIONS[name](PHY, U, U, N)
    np.testing.assert_allclose(f.numpy(), PHY.directional_flux(U, N).numpy(),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("name", ALL_FLUXES)
def test_flux_conservation(name):
    f1 = tf.FLUX_FUNCTIONS[name](PHY, U, UR2, N)
    f2 = tf.FLUX_FUNCTIONS[name](PHY, UR2, U, -N)
    np.testing.assert_allclose(f1.numpy(), -f2.numpy(), rtol=1e-12,
                               atol=1e-13)


@pytest.mark.parametrize("name", ALL_FLUXES)
@pytest.mark.parametrize("bc", [C.BC_SLIPWALL, C.BC_ADIABATIC_WALL])
def test_wall_flux_invariants(name, bc):
    """Mass and energy flux through slip and adiabatic walls vanish to 50
    machine epsilons (testwallbcs.cpp:30-67; the normal's norm is not
    exactly 1 in floating point)."""
    ug = bcs.ghost_state(PHY, U[None], N[None], torch.tensor([bc]),
                         torch.zeros(1, dtype=torch.float64),
                         torch.zeros(1, dtype=torch.float64),
                         PHY.freestream_state(0.0))[0]
    f = tf.FLUX_FUNCTIONS[name](PHY, U, ug, N)
    tol = 50 * 2.2e-16
    assert abs(float(f[0])) < tol, f"mass flux leak: {float(f[0])}"
    assert abs(float(f[3])) < tol, f"energy flux leak: {float(f[3])}"


def test_get_flux_takes_every_configurable_flux():
    assert sorted(C.FLUXES) == ALL_FLUXES
    for name in C.FLUXES:
        assert tf.get_flux(name.lower()) is tf.FLUX_FUNCTIONS[name]
    with pytest.raises(ValueError):
        tf.get_flux("SLAU")
