"""The port's banded operators with 1x1 blocks (V = 1, the scalar
diffusion's system) against the JAX package's XLA banded operators, at f64
on the CPU.

The JAX package's Pallas kernels take 4x4 blocks only, so its XLA operators
(fvens_tpu/solver/banded.py: make_banded_matvec, make_banded_bsgs) are the
reference at V = 1. On seeded numpy operators (random shifts, duplicates
among them, as the O-mesh seam bands have) and on the heat equation's step
operators on unit_square(16):
  - the plain twins of the kernels (banded_apply_plain, bsgs_apply_plain)
    and the kernel-form operator builders, which on CPU tensors take those
    twins, agree with them to 1e-13 of max|y| (the same products, summed in
    another order);
  - the band analysis of unit_square(16) is the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvens_tpu.mesh import compile_mesh as jax_compile_mesh
from fvens_tpu.mesh.meshgen import unit_square
from fvens_tpu.config import BCSpec
from fvens_tpu.solver import banded as jb
from fvens_tpu_torch.cases import model_problems as mp
from fvens_tpu_torch.solver import banded as tb
from fvens_tpu_torch.solver import banded_kernels as bk

TOL = 1e-13


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(a).max()


def _random_ops(NC, K, seed):
    """D, D^-1 (NC, 1, 1), band blocks and D^-1 N (K, 1, 1, NC) scaled so
    that a sweep contracts, K raw offsets (a duplicate among them) and x."""
    g = np.random.default_rng(seed)
    D = 2.0 + g.random((NC, 1, 1))
    Bt = g.standard_normal((K, 1, 1, NC)) / K
    Dinv = 1.0 / D
    DNbt = Bt * Dinv[:, 0, 0][None, None, None, :] * 0.5
    offsets = [int(d) for d in g.integers(-2 * NC, 2 * NC, K)]
    if K > 2:
        offsets[-1] = offsets[1] + NC           # the same shift, wrapped
    x = g.standard_normal((NC, 1))
    return D, Bt, Dinv, DNbt, tuple(offsets), x


def _heat_ops():
    """The heat equation's banded step-0 operators on unit_square(16), as
    numpy arrays."""
    solver, mesh = mp.heat_solver("cpu", 16, False, banded=True, pc="bsgs",
                                  pc_sweeps=6)
    _, _, ops = solver.step_operators(
        mesh, torch.zeros((mesh.NC, 1), dtype=torch.float64),
        solver.cfg.cfl_init)
    x = np.random.default_rng(3).standard_normal((mesh.NC, 1))
    return (ops.D.numpy(), ops.Bt.numpy(), ops.Dinv.numpy(),
            ops.DNbt.numpy(), tuple(ops.bl.offsets), x)


CASES = {"random-129-4": lambda: _random_ops(129, 4, 0),
         "random-1000-8": lambda: _random_ops(1000, 8, 1),
         "random-7-1": lambda: _random_ops(7, 1, 2),
         "heat-16": _heat_ops}


@pytest.mark.parametrize("case", list(CASES))
def test_matvec_twin_v1_matches_jax_xla(case):
    D, Bt, _, _, offsets, x = CASES[case]()
    want = jb.make_banded_matvec(jnp.asarray(D), jnp.asarray(Bt), offsets)(
        jnp.asarray(x))
    Dt, Btt, xt = (torch.from_numpy(a) for a in (D, Bt, x))
    bands, dms = bk.matvec_bands(Dt, Btt, offsets)
    assert bands.shape == (len(offsets) + 1, 1, 1, D.shape[0])
    y = bk.banded_apply_plain(bands, xt, dms)
    assert y.shape == x.shape
    assert _rel(want, y.numpy()) < TOL
    # (with 8 bands the diagonal is a launch of its own: the sum's order
    # differs from the twin's one call)
    yk = bk.make_banded_matvec_kernel(Dt, Btt, offsets)(xt)
    assert _rel(want, yk.numpy()) < TOL
    assert _rel(want, tb.make_banded_matvec(Dt, Btt, offsets)(xt)) < TOL


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("sweeps", [0, 1, 6])
def test_bsgs_twin_v1_matches_jax_xla(case, sweeps):
    _, _, Dinv, DNbt, offsets, x = CASES[case]()
    want = jb.make_banded_bsgs(jnp.asarray(Dinv), jnp.asarray(DNbt), offsets,
                               sweeps)(jnp.asarray(x))
    Dit, DNt, xt = (torch.from_numpy(a) for a in (Dinv, DNbt, x))
    (dinv, _), (dn, dms) = bk.bsgs_bands(Dit, DNt, offsets)
    z = bk.bsgs_apply_plain(dinv, dn, dms, sweeps, xt)
    assert z.shape == x.shape
    assert _rel(want, z.numpy()) < TOL
    zk = bk.make_banded_bsgs_kernel(Dit, DNt, offsets, sweeps)(xt)
    assert torch.equal(zk, z)
    zs = bk.make_banded_bsgs_sequence(Dit, DNt, offsets, sweeps)(xt)
    assert _rel(want, zs.numpy()) < TOL


def test_heat_band_structure_v1_matches_jax():
    bcs = [BCSpec(marker=1, type="dirichlet", values=(0.0,))]
    blj = jb.banded_structure(jax_compile_mesh(unit_square(16), bcs))
    _, mesh = mp.heat_solver("cpu", 16, False, banded=True)
    blt = tb.banded_structure(mesh)
    assert blt.offsets == blj.offsets == (-16, -1, 1, 16)
    assert np.array_equal(blt.valid.numpy(), np.asarray(blj.valid))
    assert np.array_equal(blt.slot_sel.numpy(), np.asarray(blj.slot_sel))


def test_wrappers_refuse_other_block_sizes():
    """V is read from the operands: 1 and 4 run, any other V raises
    ValueError naming it, before any launch and on the CPU too."""
    for V in (2, 3, 5):
        bands = torch.zeros(2, V, V, 8, dtype=torch.float64)
        with pytest.raises(ValueError, match=f"{V}x{V}"):
            bk.BandedApply(bands, (0, 1))
        with pytest.raises(ValueError, match=f"{V}x{V}"):
            bk.BsgsApply(bands[:1], bands, (0, 1), 2)
    with pytest.raises(ValueError):                     # 1x4 blocks
        bk.BandedApply(torch.zeros(2, 1, 4, 8), (0, 1))
    app = bk.BandedApply(torch.zeros(2, 1, 1, 8, dtype=torch.float64), (0, 1))
    assert app.V == 1
    with pytest.raises(ValueError):                     # x of V = 4
        app(torch.zeros(8, 4, dtype=torch.float64))
