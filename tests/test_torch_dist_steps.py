"""One implicit step of the port's domain-decomposed path against the JAX
package's, on the CPU at f64 (tests/test_dist.py: the implicit and the
matrix-free steps): bjacobi at rtol 1e-10 from the free stream at CFL 50
on cylinder_omesh(32, 12), with the assembled matvec (res 1e-10; u 1e-7,
1e-9), the exact-JVP (u 1e-7) and the FD shell (u 1e-6), in gloo worlds
of D = 2 and 4 ranks against D of the 8 virtual CPU devices
(tests/test_torch_dist.py says how); each in the host form (_step) and
in the device form (_device_step: gmres_device over reduced inner
products, run under torch_dist_ranks.NoHostRead, reading nothing back),
both held to the same JAX step.
"""

import numpy as np
import pytest

import torch_dist_ranks as R
from test_torch_dist import WORLDS, jax_flow, jax_space, jax_step, port_world


KINDS = [("implicit", 1e-7), ("mf_jvp", 1e-7), ("mf_fd", 1e-6)]
_JAX = {}


def _jax_step(D, kind):
    """The JAX package's step of `kind` on D devices, computed once."""
    if (D, kind) not in _JAX:
        lin = dict(R.TIGHT, pc="bjacobi", matrix_free=kind != "implicit",
                   matrix_free_fd=kind == "mf_fd")
        _JAX[D, kind] = jax_step(jax_flow(jax_space(), D), D, **lin)
    return _JAX[D, kind]


def _held_to_jax(got, D, kind, tol):
    u1, res, it = got
    ju, jres, jit = _jax_step(D, kind)
    np.testing.assert_allclose(res, jres, rtol=1e-10)
    atol = 1e-9 if kind == "implicit" else 10 * tol * 1e-2
    np.testing.assert_allclose(u1, ju, rtol=tol, atol=atol)
    assert it == jit


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("kind,tol", KINDS)
def test_sharded_implicit_step_matches_jax(D, kind, tol):
    """One implicit bjacobi step at rtol 1e-10: assembled, exact-JVP and
    FD matvecs (tests/test_dist.py: the implicit and matrix-free steps)."""
    _held_to_jax(port_world(R.implicit_steps, D)[kind], D, kind, tol)


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("kind,tol", KINDS)
def test_sharded_device_step_matches_jax(D, kind, tol):
    """The device form of the same steps, reading nothing back, held to
    the JAX package's DistributedBackwardEuler._step as the host form
    is."""
    _held_to_jax(port_world(R.implicit_steps, D)[("device", kind)], D, kind,
                 tol)
