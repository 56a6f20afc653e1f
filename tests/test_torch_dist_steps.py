"""One implicit step of the port's domain-decomposed path against the JAX
package's, on the CPU at f64 (tests/test_dist.py: the implicit and the
matrix-free steps): bjacobi at rtol 1e-10 from the free stream at CFL 50
on cylinder_omesh(32, 12), with the assembled matvec (res 1e-10; u 1e-7,
1e-9), the exact-JVP (u 1e-7) and the FD shell (u 1e-6), in gloo worlds
of D = 2 and 4 ranks against D of the 8 virtual CPU devices
(tests/test_torch_dist.py says how).
"""

import numpy as np
import pytest

import torch_dist_ranks as R
from test_torch_dist import WORLDS, jax_flow, jax_space, jax_step, port_world


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("kind,tol", [("implicit", 1e-7), ("mf_jvp", 1e-7),
                                      ("mf_fd", 1e-6)])
def test_sharded_implicit_step_matches_jax(D, kind, tol):
    """One implicit bjacobi step at rtol 1e-10: assembled, exact-JVP and
    FD matvecs (tests/test_dist.py: the implicit and matrix-free steps)."""
    u1, res, it = port_world(R.implicit_steps, D)[kind]
    lin = dict(R.TIGHT, pc="bjacobi", matrix_free=kind != "implicit",
               matrix_free_fd=kind == "mf_fd")
    sf = jax_flow(jax_space(), D)
    ju, jres, jit = jax_step(sf, D, **lin)
    np.testing.assert_allclose(res, jres, rtol=1e-10)
    atol = 1e-9 if kind == "implicit" else 10 * tol * 1e-2
    np.testing.assert_allclose(u1, ju, rtol=tol, atol=atol)
    assert it == jit
