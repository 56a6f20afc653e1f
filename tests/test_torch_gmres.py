"""The port's FGMRES against the JAX package's classic (CGS2) GMRES on a
frozen Jacobian of the bench physics, with the banded bsgs preconditioner:
the same iteration count and the same solution to 1e-10 of max|x| at f64
(the Givens work runs on the host in the port, on the device in JAX; both
round at f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvens_tpu.solver import banded as jb
from fvens_tpu.solver.linear import block_jacobi_inverse as jax_bjinv
from fvens_tpu.solver.linear import gmres as jax_gmres
from fvens_tpu_torch import interop
from fvens_tpu_torch.solver import banded as tb
from fvens_tpu_torch.solver.linear import block_jacobi_inverse, gmres

from test_torch_banded import _ops


def _systems(cfl):
    jm, tm, D, N = _ops(cfl=cfl)
    blj, blt = jb.banded_structure(jm), tb.banded_structure(tm)
    Dj, Nj = jnp.asarray(D), jnp.asarray(N)
    Dinv_j = jax_bjinv(Dj)
    mv_j = jb.make_banded_matvec(Dj, jb.banded_blocks(blj, Nj), blj.offsets)
    pc_j = jb.make_banded_bsgs(Dinv_j, jb.banded_dn_blocks(blj, Dinv_j, Nj),
                               blj.offsets, 6)
    Jt = interop.jacobian_from_numpy(D, N, device="cpu")
    Dinv_t = block_jacobi_inverse(Jt.D)
    mv_t = tb.make_banded_matvec(Jt.D, tb.banded_blocks(blt, Jt.N),
                                 blt.offsets)
    pc_t = tb.make_banded_bsgs(Dinv_t, tb.banded_dn_blocks(blt, Dinv_t, Jt.N),
                               blt.offsets, 6)
    b = np.random.default_rng(7).standard_normal((tm.NC, 4))
    b[tm.n_cells:] = 0.0
    return (mv_j, pc_j), (mv_t, pc_t), b


@pytest.mark.parametrize("cfl,restart,maxiter,rtol", [
    (50.0, 90, 90, 1e-8),        # one cycle, converges inside it
    (500.0, 10, 100, 1e-4),      # restarts: converges in a later cycle
    (500.0, 8, 16, 1e-12),       # stops at maxiter without converging
])
def test_gmres_matches_jax(cfl, restart, maxiter, rtol):
    (mv_j, pc_j), (mv_t, pc_t), b = _systems(cfl)
    run = jax.jit(lambda bb: jax_gmres(mv_j, bb, jnp.zeros_like(bb), pc_j,
                                       restart=restart, maxiter=maxiter,
                                       rtol=rtol))
    xj, itj, rrj = run(jnp.asarray(b))
    bt = torch.from_numpy(b)
    xt, itt, rrt = gmres(mv_t, bt, torch.zeros_like(bt), pc_t,
                         restart=restart, maxiter=maxiter, rtol=rtol)
    assert isinstance(itt, int) and itt == int(itj)
    assert itt <= maxiter
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()
    assert abs(float(rrt) - float(rrj)) <= 1e-8 * float(rrj)
    # the reported relres is the true preconditioned-system residual
    true = float(torch.linalg.vector_norm(bt - mv_t(xt))
                 / torch.linalg.vector_norm(bt))
    assert true <= 1.01 * float(rrt) + 1e-12
    if itt < maxiter:
        assert float(rrt) <= rtol


def test_gmres_f32_stays_f32():
    (_, _), (mv_t, pc_t), b = _systems(50.0)
    f32 = lambda f: (lambda v: f(v.double()).float())
    bt = torch.from_numpy(b).float()
    x, it, rr = gmres(f32(mv_t), bt, torch.zeros_like(bt), f32(pc_t),
                      restart=30, maxiter=30, rtol=1e-3)
    assert x.dtype == torch.float32 and rr.dtype == np.float32
    assert 0 < it <= 30 and rr <= 1e-3
