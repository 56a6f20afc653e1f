"""The port's residual for every (flux, reconstruction) pair against the
JAX package's, at f64, at the seeded state of tests/test_torch_
reconstruction.py on its transonic NACA0012 mesh (naca0012_omesh(32, 16),
M 0.8, AoA 1.25, slip wall + far field): rhs and local dt to 1e-12 of the
largest entry. The slot Jacobian of every pair is
tests/test_torch_jacobian_pairs.py.
"""

import numpy as np
import pytest

from fvens_tpu_torch.cases.casesolvers import build_space
from fvens_tpu_torch.config import FLUXES, RECONSTRUCTIONS

from test_torch_reconstruction import (LIMITER_PARAM, _close, _jax_residual,
                                       _t, config, meshes)

@pytest.mark.parametrize("flux", FLUXES)
@pytest.mark.parametrize("recon", RECONSTRUCTIONS)
def test_residual_matches_jax(flux, recon):
    """rhs and local dt on the transonic NACA mesh for every (flux,
    reconstruction) pair."""
    _, tm, u = meshes("naca")
    rj, dj = _jax_residual("naca", flux, recon)
    ts = build_space(config("naca", flux=flux, reconstruction=recon,
                            limiter_param=LIMITER_PARAM.get(recon, 0.0)))
    rt, dt = ts.compute_residual(tm, _t(u), True)
    assert np.isfinite(rj).all()
    _close(rj, rt.numpy(), 1e-12)
    _close(dj, dt.numpy(), 1e-12)
