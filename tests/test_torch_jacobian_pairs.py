"""The port's first-order slot Jacobian for every (flux, reconstruction)
pair against the JAX package's, at f64, CONSISTENT and FROZEN, at the
seeded state of tests/test_torch_reconstruction.py on its
cylinder_omesh(24, 10) (M 0.38, slip wall + far field): blocks to 1e-11 of
the largest entry (forward-mode AD in two frameworks). The symmetric mesh
puts zero normal velocities on the faces along the x axis and mirrored
states on the wall, where the derivative of |x| at 0 must be the JAX
package's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fvens_tpu.cases.casesolvers import build_space as jax_build_space
from fvens_tpu_torch.cases.casesolvers import build_space
from fvens_tpu_torch.config import FLUXES, RECONSTRUCTIONS

from test_torch_reconstruction import LIMITER_PARAM, _close, _t, config, meshes
from test_torch_residual import to_jax_config


@functools.lru_cache(maxsize=None)
def _jax_jacobian(flux, mode):
    jm, _, u = meshes("cylinder")
    js = jax_build_space(to_jax_config(config(flux=flux,
                                              flux_jacobian=mode)))
    jac = jax.jit(js.assemble_jacobian)(jm, jnp.asarray(u))
    return np.asarray(jac.D), np.asarray(jac.N)


@pytest.mark.parametrize("flux", FLUXES)
@pytest.mark.parametrize("recon", RECONSTRUCTIONS)
def test_jacobian_matches_jax(flux, recon):
    """The first-order slot Jacobian, CONSISTENT and FROZEN, for every
    (flux, reconstruction) pair: the reconstruction never enters it, which
    the JAX package's blocks of the pair's config confirm."""
    _, tm, u = meshes("cylinder")
    for mode in ("CONSISTENT", "FROZEN"):
        D, N = _jax_jacobian(flux, mode)
        ts = build_space(config(flux=flux, reconstruction=recon,
                                flux_jacobian=mode,
                                limiter_param=LIMITER_PARAM.get(recon, 0.0)))
        jac = ts.assemble_jacobian(tm, _t(u))
        assert np.isfinite(D).all() and np.isfinite(N).all()
        _close(D, jac.D.numpy(), 1e-11)
        _close(N, jac.N.numpy(), 1e-11)


