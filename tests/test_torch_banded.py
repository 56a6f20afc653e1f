"""The port's banded operators against the JAX package's.

On a real assembled Jacobian of the bench physics (naca0012_omesh(64, 16),
fully band-covered by 6 bands including the two seam bands):
  - the band analysis is identical;
  - the plain PyTorch twins (solver/banded.py) agree with the JAX package's
    XLA banded operators at f64 to 1e-13 of max|y| (the same products,
    summed in another order);
  - the kernel-form operators (solver/banded_kernels.py), which on CPU
    tensors take the plain twin of the kernel, agree with the TPU kernels
    run in Pallas interpret mode at f32 to 1e-5 of max|y|;
  - the fused bsgs apply (one launch on the card) takes, on CPU tensors,
    exactly the arithmetic of the banded twin, and its launch plan covers
    every cell once within the shared memory it is given.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvens_tpu.solver import banded as jb
from fvens_tpu.solver import jacobian as jjac
from fvens_tpu.solver import pallas_banded as pb
from fvens_tpu.solver.linear import BlockJacobian as JaxBlockJacobian
from fvens_tpu.solver.linear import block_jacobi_inverse as jax_bjinv
from fvens_tpu.solver.linear import bsr_matvec as jax_bsr_matvec
from fvens_tpu_torch import interop
from fvens_tpu_torch.solver import banded as tb
from fvens_tpu_torch.solver import banded_kernels as bk
from fvens_tpu_torch.solver.linear import (block_jacobi_inverse,
                                           make_bsr_matvec)

from test_torch_residual import _case, jax_space


def _ops(dtype=np.float64, cfl=50.0):
    """JAX-assembled D, N (with the pseudo-time term at `cfl`) and the
    meshes."""
    jm, tm, js, ts, u = _case(seed=4)
    _, res, _, jac = jax_space()
    J = jac(jm, jnp.asarray(u))
    _, dt = res(jm, jnp.asarray(u))
    J = jjac.add_pseudotime_term(jm, J, cfl, dt)
    D, N = np.asarray(J.D, dtype), np.asarray(J.N, dtype)
    return jm, tm, D, N


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(a).max()


def test_structure_matches_jax_and_keeps_seam_bands():
    jm, tm, _, _, _ = _case()
    blj, blt = jb.banded_structure(jm), tb.banded_structure(tm)
    assert blt.offsets == blj.offsets
    assert len(blt.offsets) == 6
    assert np.array_equal(blt.slot_sel.numpy(), np.asarray(blj.slot_sel))
    assert np.array_equal(blt.valid.numpy(), np.asarray(blj.valid))
    dms = tb._norm_offsets(blt.offsets, tm.NC)
    # the two seam bands share a normalized shift with two interior bands
    assert len(set(dms)) < len(dms)
    assert dms == jb._norm_offsets(blj.offsets, jm.NC)


def test_twins_match_jax_banded_f64():
    jm, tm, D, N = _ops()
    blj, blt = jb.banded_structure(jm), tb.banded_structure(tm)
    Jt = interop.jacobian_from_numpy(D, N, device="cpu")
    Btj = jb.banded_blocks(blj, jnp.asarray(N))
    Btt = tb.banded_blocks(blt, Jt.N)
    assert Btt.is_contiguous()
    assert _rel(Btj, Btt.numpy()) == 0.0
    Dinv_j = jax_bjinv(jnp.asarray(D))
    Dinv_t = block_jacobi_inverse(Jt.D)
    assert _rel(Dinv_j, Dinv_t.numpy()) < 1e-14
    DNj = jb.banded_dn_blocks(blj, Dinv_j, jnp.asarray(N))
    DNt = tb.banded_dn_blocks(blt, Dinv_t, Jt.N)
    assert _rel(DNj, DNt.numpy()) < 1e-13

    x = np.random.default_rng(5).standard_normal((tm.NC, 4))
    yj = jb.make_banded_matvec(jnp.asarray(D), Btj, blj.offsets)(
        jnp.asarray(x))
    yt = tb.make_banded_matvec(Jt.D, Btt, blt.offsets)(torch.from_numpy(x))
    assert _rel(yj, yt.numpy()) < 1e-13
    zj = jb.make_banded_bsgs(Dinv_j, DNj, blj.offsets, 6)(jnp.asarray(x))
    zt = tb.make_banded_bsgs(Dinv_t, DNt, blt.offsets, 6)(torch.from_numpy(x))
    assert _rel(zj, zt.numpy()) < 1e-13


def test_banded_matvec_is_the_slot_gather_matvec_f64():
    """The banded encoding changes only the summation order: the twin
    agrees with the port's slot-gather matvec, which agrees with the JAX
    package's, to 1e-13 of max|y|."""
    jm, tm, D, N = _ops()
    Jt = interop.jacobian_from_numpy(D, N, device="cpu")
    x = np.random.default_rng(7).standard_normal((tm.NC, 4))
    yg = make_bsr_matvec(tm, Jt)(torch.from_numpy(x))
    Jj = JaxBlockJacobian(D=jnp.asarray(D), N=jnp.asarray(N))
    yj = jax_bsr_matvec(jm, Jj, jnp.asarray(x))
    assert _rel(yj, yg.numpy()) < 1e-13
    blt = tb.banded_structure(tm)
    yb = tb.make_banded_matvec(Jt.D, tb.banded_blocks(blt, Jt.N),
                               blt.offsets)(torch.from_numpy(x))
    assert _rel(yg.numpy(), yb.numpy()) < 1e-13


def test_kernel_operators_match_pallas_interpret_f32():
    jm, tm, D, N = _ops(np.float32)
    blj, blt = jb.banded_structure(jm), tb.banded_structure(tm)
    Dj, Nj = jnp.asarray(D), jnp.asarray(N)
    Jt = interop.jacobian_from_numpy(D, N, device="cpu")
    Dinv_j = jax_bjinv(Dj)
    Dinv_t = block_jacobi_inverse(Jt.D)
    x = np.random.default_rng(6).standard_normal((tm.NC, 4)) \
        .astype(np.float32)
    xt = torch.from_numpy(x)

    yj = pb.make_banded_matvec_pallas(Dj, jb.banded_blocks(blj, Nj),
                                      blj.offsets, interpret=True)(
        jnp.asarray(x))
    yt = bk.make_banded_matvec_kernel(Jt.D, tb.banded_blocks(blt, Jt.N),
                                      blt.offsets)(xt)
    assert yt.dtype == torch.float32
    assert _rel(yj, yt.numpy()) < 1e-5

    zj = pb.make_banded_bsgs_pallas(
        Dinv_j, jb.banded_dn_blocks(blj, Dinv_j, Nj), blj.offsets, 6,
        interpret=True)(jnp.asarray(x))
    zt = bk.make_banded_bsgs_kernel(
        Dinv_t, tb.banded_dn_blocks(blt, Dinv_t, Jt.N), blt.offsets, 6)(xt)
    assert _rel(zj, zt.numpy()) < 1e-5


@pytest.mark.parametrize("K,base", [(7, False), (1, False), (6, True)])
def test_kernel_wrapper_routes_cpu_to_twin(K, base):
    """On CPU tensors the wrapper runs the plain twin (no launch counted)
    and matches the dense definition out = base + sign sum_k B_k x_(+d_k)."""
    rng = np.random.default_rng(K)
    NC = 40
    bands = torch.from_numpy(rng.standard_normal((K, 4, 4, NC)))
    x = torch.from_numpy(rng.standard_normal((NC, 4)))
    b = torch.from_numpy(rng.standard_normal((NC, 4))) if base else None
    dms = tuple(int(d) for d in rng.integers(-NC // 2, NC // 2, K))
    sign = -1.0 if base else 1.0
    before = bk.banded_apply.launches
    y = bk.banded_apply(bands, x, dms, sign=sign, base=b)
    assert bk.banded_apply.launches == before
    assert y.is_contiguous() and y.shape == (NC, 4)
    want = np.zeros((NC, 4)) if b is None else b.numpy().copy()
    B, X = bands.numpy(), x.numpy()
    for c in range(NC):
        for k, d in enumerate(dms):
            want[c] += sign * B[k, :, :, c] @ X[(c + d) % NC]
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-13, atol=1e-13)
    assert torch.equal(y, bk.banded_apply_plain(bands, x, dms, sign, b))


def test_kernel_wrapper_checks_inputs():
    bands = torch.zeros(2, 4, 4, 8)
    x = torch.zeros(8, 4)
    with pytest.raises(ValueError):
        bk.banded_apply(bands, torch.zeros(9, 4), (0, 1))
    with pytest.raises(ValueError):
        bk.banded_apply(bands, x, (0,))                     # one shift short
    with pytest.raises(ValueError):
        bk.banded_apply(torch.zeros(9, 4, 4, 8), x, (0,) * 9)
    with pytest.raises(TypeError):
        bk.banded_apply(bands, x.double(), (0, 1))
    with pytest.raises(TypeError):
        bk.banded_apply(bands.half(), x.half(), (0, 1))
    with pytest.raises(ValueError):
        bk.banded_apply(bands, torch.zeros(4, 8).T, (0, 1))  # not contiguous
    with pytest.raises(ValueError):
        bk.banded_apply(bands, x, (0, 1), base=torch.zeros(8, 3))


def _bsgs_inputs(NC, K, seed=0):
    """Random dinv (1, 4, 4, NC), dn (K, 4, 4, NC), normalized shifts and
    v (NC, 4), f64."""
    g = np.random.default_rng(seed)
    dinv = torch.from_numpy(g.standard_normal((1, 4, 4, NC)))
    dn = torch.from_numpy(g.standard_normal((K, 4, 4, NC)) / (4 * K))
    dms = tuple(int(d) for d in tb._norm_offsets(
        g.integers(-NC, NC, K), NC))
    return dinv, dn, dms, torch.from_numpy(g.standard_normal((NC, 4)))


@pytest.mark.parametrize("sweeps", [0, 1, 6])
@pytest.mark.parametrize("K", [1, 6, 8])
def test_bsgs_apply_cpu_is_the_banded_twin(K, sweeps):
    """On CPU tensors bsgs_apply is banded.make_banded_bsgs's arithmetic,
    value for value, and launches nothing."""
    dinv, dn, dms, v = _bsgs_inputs(50, K, seed=K + sweeps)
    n0, f0 = bk.banded_apply.launches, bk.bsgs_apply.launches
    z = bk.bsgs_apply(dinv, dn, dms, sweeps, v)
    assert (bk.banded_apply.launches, bk.bsgs_apply.launches) == (n0, f0)
    assert z.shape == (50, 4) and z.is_contiguous()
    want = tb.make_banded_bsgs(dinv[0].permute(2, 0, 1), dn, dms, sweeps)(v)
    assert torch.equal(z, want)
    if sweeps == 0:
        assert torch.equal(z, bk.banded_apply_plain(dinv, v, (0,)))


@pytest.mark.parametrize("form", ["builder", "bands"])
def test_bsgs_sequence_matches_fused_twin_f64(form):
    """The seven-launch form (the fused kernel's reference on the card),
    from the step's operators or from the bands, computes the same apply:
    on CPU tensors, to 1e-13 of max|y| (its twin sums the bands in another
    order)."""
    dinv, dn, dms, v = _bsgs_inputs(60, 6, seed=3)
    seq = (bk.make_banded_bsgs_sequence(dinv[0].permute(2, 0, 1), dn, dms, 6)
           if form == "builder" else bk.bsgs_sequence(dinv, dn, dms, 6))
    assert _rel(bk.bsgs_apply(dinv, dn, dms, 6, v), seq(v)) < 1e-13


@pytest.mark.parametrize("dtype", ["f64 banded", "f32 pallas"])
def test_fused_pc_builder_matches_jax(dtype):
    """make_banded_bsgs_kernel's CPU path against the JAX package on the
    step operators of naca0012_omesh(64, 16): at f64 against
    solver/banded.py's bsgs to 1e-13 of max|z| (the same products summed
    in another order), at f32 against make_banded_bsgs_pallas in interpret
    mode to 1e-5 (f32 rounding in another summation order, over up to six
    sweeps)."""
    f64 = dtype.startswith("f64")
    jm, tm, D, N = _ops(np.float64 if f64 else np.float32)
    blj, blt = jb.banded_structure(jm), tb.banded_structure(tm)
    Jt = interop.jacobian_from_numpy(D, N, device="cpu")
    Dinv_j = jax_bjinv(jnp.asarray(D))
    Dinv_t = block_jacobi_inverse(Jt.D)
    DNj = jb.banded_dn_blocks(blj, Dinv_j, jnp.asarray(N))
    DNt = tb.banded_dn_blocks(blt, Dinv_t, Jt.N)
    x = np.random.default_rng(8).standard_normal((tm.NC, 4)) \
        .astype(D.dtype)
    for sweeps in (0, 1, 6):
        if f64:
            zj = jb.make_banded_bsgs(Dinv_j, DNj, blj.offsets, sweeps)(
                jnp.asarray(x))
        else:
            zj = pb.make_banded_bsgs_pallas(Dinv_j, DNj, blj.offsets, sweeps,
                                            interpret=True)(jnp.asarray(x))
        zt = bk.make_banded_bsgs_kernel(Dinv_t, DNt, blt.offsets, sweeps,
                                        blt.support)(
            torch.from_numpy(x))
        assert zt.dtype == (torch.float64 if f64 else torch.float32)
        assert _rel(zj, zt.numpy()) < (1e-13 if f64 else 1e-5), sweeps


@pytest.mark.parametrize("NC", [1, 129, 12_800, 204_800])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bsgs_launch_plan_covers_every_cell_once(dtype, NC):
    """Every cell in exactly one block's range, no empty block, at most
    n_blocks blocks; n_res as many cells, in 16-byte runs, as the shared
    memory holds after the kernel's header, never more, and never more
    than a block's range."""
    a = bk.bsgs_align(dtype)
    for K in (1, 6, 8):
        per_cell = bk.bsgs_cell_bytes(K, dtype)
        assert per_cell == (16 * K + 4) * (4 if dtype == torch.float32
                                           else 8)
        for n_blocks in (1, 132, 1000):
            for smem in (0, per_cell - 1, 48 * 1024, 232_448, 1 << 30):
                p = bk.bsgs_launch_plan(NC, K, dtype, smem, n_blocks)
                assert 1 <= p.blocks <= n_blocks
                hits = np.zeros(NC, dtype=np.int64)
                for b in range(p.blocks):
                    lo, hi = b * p.chunk, min((b + 1) * p.chunk, NC)
                    assert lo < hi
                    hits[lo:hi] += 1
                assert (hits == 1).all()
                assert 0 <= p.n_res <= p.chunk
                assert p.smem_bytes == (
                    16 + p.n_res * per_cell if p.n_res else 0) <= smem
                assert (p.n_res + a > p.chunk
                        or 16 + (p.n_res + a) * per_cell > smem)


def test_bsgs_wrapper_refuses_bad_input():
    dinv, dn, dms, v = _bsgs_inputs(16, 6)
    with pytest.raises(ValueError):
        bk.bsgs_apply(dinv, dn, dms, 6, v[:15])                 # v's NC
    with pytest.raises(ValueError):
        bk.bsgs_apply(dinv, dn, dms[:5], 6, v)                  # shift short
    with pytest.raises(ValueError):
        bk.bsgs_apply(dinv, torch.zeros(9, 4, 4, 16, dtype=dn.dtype),
                      (0,) * 9, 6, v)                           # K = 9
    with pytest.raises(ValueError):
        bk.bsgs_apply(dinv[:, :3], dn, dms, 6, v)               # dinv shape
    with pytest.raises(ValueError):
        bk.bsgs_apply(dinv, dn, dms, -1, v)                     # sweeps < 0
    with pytest.raises(ValueError):
        bk.bsgs_apply(dinv, dn, dms, 2.0, v)                    # not an int
    with pytest.raises(TypeError):
        bk.bsgs_apply(dinv, dn, dms, 6, v.float())              # mixed dtype
    with pytest.raises(TypeError):
        bk.bsgs_apply(dinv.half(), dn.half(), dms, 6, v.half())
    with pytest.raises(ValueError):
        bk.bsgs_apply(dinv, dn.transpose(1, 2), dms, 6, v)      # strided
    with pytest.raises(ValueError):
        bk.bsgs_apply(dinv, dn, dms, 6, v, support=[(0, 16)] * 5)
    with pytest.raises(ValueError):
        bk.bsgs_apply(dinv, dn, dms, 6, v, support=[(4, 2)] * 6)
    with pytest.raises(ValueError):
        bk.bsgs_launch_plan(0, 6, torch.float32, 1024, 132)     # no cells
    with pytest.raises(ValueError):
        bk.bsgs_launch_plan(16, 6, torch.float32, 1024, 0)      # no blocks


def test_band_supports_hold_every_valid_cell():
    """BandedStructure.support: every valid cell of band k lies in
    [lo_k, hi_k) (so the band's blocks are zero outside), the range is the
    tightest, and on the O-mesh the two seam bands span one ring of cells
    and are the two that the fused kernel leaves out of shared memory."""
    _, tm, _, _, _ = _case()
    bl = tb.banded_structure(tm)
    valid = bl.valid.numpy()
    for k, (lo, hi) in enumerate(bl.support):
        cells = np.flatnonzero(valid[k])
        assert (lo, hi) == (cells[0], cells[-1] + 1)
    widths = sorted(hi - lo for lo, hi in bl.support)
    assert widths[:2] == [16, 16] and min(widths[2:]) > tm.NC // 2
    dense = bk.bsgs_dense_bands(bl.support, tm.NC)
    assert sum(dense) == 4
    assert all(not d for d, (lo, hi) in zip(dense, bl.support)
               if hi - lo == 16)
