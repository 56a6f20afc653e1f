"""The CUDA kernels (banded_apply, the fused bsgs apply, row_set) against
their plain PyTorch twins, on the card. The banded kernels at both block
sizes they are built for: the flow equations' 4x4 blocks and the scalar
diffusion's 1x1 blocks (the `_v1` tests, on the heat equation's operators
and on random ones).

Needs a CUDA card and nvcc: marked `gpu`, and each test skips when
torch.cuda.is_available() is false. Imports no JAX, so it runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py

Tolerances: banded_apply and the fused bsgs apply f32 to 1e-5 of max|y|,
f64 to 1e-12 of max|y| of their twins (the kernels fuse multiply-adds and
sum bands in another order than the twins); the fused bsgs apply equals the
seven-launch banded_apply sequence value for value (both run the cell
arithmetic of csrc/banded_block.cuh); row_set bit for bit (one true IEEE
division per element, as the twin).
"""

import numpy as np
import pytest
import torch

from fvens_tpu_torch.cases import model_problems as mp
from fvens_tpu_torch.cases.bench_case import bench_solver
from fvens_tpu_torch.cases.casesolvers import initial_state
from fvens_tpu_torch.solver import banded as tb
from fvens_tpu_torch.solver import banded_kernels as bk
from fvens_tpu_torch.solver import rowset_kernels as rk

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _ops(dev, dtype, mesh=(64, 16)):
    """The solver's banded operators at a perturbed free stream, at `dtype`
    (f32: the mixed-precision Krylov system)."""
    solver, cm = bench_solver(dev, mesh=mesh, mixed=dtype == torch.float32)
    u0 = initial_state(solver.space, cm)
    u0 = u0 * (1.0 + 0.01 * torch.from_numpy(
        np.random.default_rng(0).standard_normal(tuple(u0.shape))).to(dev))
    _, _, ops = solver.step_operators(cm, u0, 500.0)
    assert ops.D.dtype == dtype
    return cm, ops


def _heat_ops(dev, dtype, n=64):
    """The heat equation's banded step-0 operators (V = 1) on
    unit_square(n), at `dtype` (f32: the mixed-precision Krylov system)."""
    solver, mesh = mp.heat_solver(dev, n, False, banded=True, pc="bsgs",
                                  pc_sweeps=6,
                                  mixed_precision=dtype == torch.float32)
    u0 = torch.zeros((mesh.NC, 1), dtype=torch.float64, device=dev)
    _, _, ops = solver.step_operators(mesh, u0, solver.cfg.cfl_init)
    assert ops.D.dtype == dtype and ops.D.shape[1:] == (1, 1)
    return mesh, ops


def _rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_twin_on_step_operators(cuda, dtype):
    cm, ops = _ops(cuda, dtype)
    offs = ops.bl.offsets
    bands7, d7 = bk.matvec_bands(ops.D, ops.Bt, offs)
    (bands1, d1), (bandsn, dms_n) = bk.bsgs_bands(ops.Dinv, ops.DNbt, offs)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (cm.NC, 4))).to(cuda, dtype)
    base = bk.banded_apply_plain(bands1, x, d1)
    for bands, dms, sign, b in ((bands7, d7, 1.0, None),
                                (bands1, d1, 1.0, None),
                                (bandsn, dms_n, -1.0, base)):
        n0 = bk.banded_apply.launches
        y = bk.banded_apply(bands, x, dms, sign, b)
        torch.cuda.synchronize()
        assert bk.banded_apply.launches == n0 + 1
        assert y.dtype == dtype and y.is_cuda
        assert _rel_err(y, bk.banded_apply_plain(bands, x, dms, sign, b)) \
            <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_operators_match_twin_operators(cuda, dtype):
    cm, ops = _ops(cuda, dtype)
    offs = ops.bl.offsets
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (cm.NC, 4))).to(cuda, dtype)
    mv_k = bk.make_banded_matvec_kernel(ops.D, ops.Bt, offs)
    mv_p = tb.make_banded_matvec(ops.D, ops.Bt, offs)
    assert _rel_err(mv_k(x), mv_p(x)) <= TOL[dtype]
    pc_k = bk.make_banded_bsgs_kernel(ops.Dinv, ops.DNbt, offs, 6,
                                      ops.bl.support)
    pc_s = bk.make_banded_bsgs_sequence(ops.Dinv, ops.DNbt, offs, 6)
    pc_p = tb.make_banded_bsgs(ops.Dinv, ops.DNbt, offs, 6)
    n0, f0 = bk.banded_apply.launches, bk.bsgs_apply.launches
    z = pc_k(x)
    assert bk.bsgs_apply.launches == f0 + 1
    assert bk.banded_apply.launches == n0
    zs = pc_s(x)
    torch.cuda.synchronize()
    assert bk.banded_apply.launches == n0 + 7
    assert torch.equal(z, zs)
    assert _rel_err(z, pc_p(x)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_twin_on_step_operators_v1(cuda, dtype):
    """The heat equation's matvec (K = 5 with the diagonal), D^-1 v
    (K = 1) and a sweep (K = 4) with 1x1 blocks."""
    mesh, ops = _heat_ops(cuda, dtype)
    offs = ops.bl.offsets
    bands5, d5 = bk.matvec_bands(ops.D, ops.Bt, offs)
    (bands1, d1), (bandsn, dms_n) = bk.bsgs_bands(ops.Dinv, ops.DNbt, offs)
    assert bands5.shape[:3] == (5, 1, 1) and bandsn.shape[:3] == (4, 1, 1)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (mesh.NC, 1))).to(cuda, dtype)
    base = bk.banded_apply_plain(bands1, x, d1)
    for bands, dms, sign, b in ((bands5, d5, 1.0, None),
                                (bands1, d1, 1.0, None),
                                (bandsn, dms_n, -1.0, base)):
        n0 = bk.banded_apply.launches
        y = bk.banded_apply(bands, x, dms, sign, b)
        torch.cuda.synchronize()
        assert bk.banded_apply.launches == n0 + 1
        assert y.shape == (mesh.NC, 1) and y.dtype == dtype and y.is_cuda
        assert _rel_err(y, bk.banded_apply_plain(bands, x, dms, sign, b)) \
            <= TOL[dtype]
    pc_k = bk.make_banded_bsgs_kernel(ops.Dinv, ops.DNbt, offs, 6,
                                      ops.bl.support)
    pc_s = bk.make_banded_bsgs_sequence(ops.Dinv, ops.DNbt, offs, 6)
    z = pc_k(x)
    assert torch.equal(z, pc_s(x))
    assert _rel_err(z, tb.make_banded_bsgs(ops.Dinv, ops.DNbt, offs, 6)(x)) \
        <= TOL[dtype]


@pytest.mark.parametrize("NC,K", [(1, 1), (129, 8), (1000, 6)])
def test_kernel_any_size_and_shift(cuda, NC, K):
    """Ragged last block, K up to 8, shifts beyond +-NC/2 and duplicates."""
    g = np.random.default_rng(NC)
    bands = torch.from_numpy(g.standard_normal((K, 4, 4, NC))).to(cuda)
    x = torch.from_numpy(g.standard_normal((NC, 4))).to(cuda)
    b = torch.from_numpy(g.standard_normal((NC, 4))).to(cuda)
    dms = tuple(int(d) for d in g.integers(-2 * NC, 2 * NC, K))
    y = bk.banded_apply(bands, x, dms, -1.0, b)
    assert _rel_err(y, bk.banded_apply_plain(bands, x, dms, -1.0, b)) <= 1e-12


@pytest.mark.parametrize("NC,K", [(1, 1), (129, 8), (1000, 6),
                                  (262_144, 5)])
def test_kernel_any_size_and_shift_v1(cuda, NC, K):
    """1x1 blocks: ragged last block, K up to 8, shifts beyond +-NC/2 and
    duplicates; every row of x is one scalar."""
    g = np.random.default_rng(NC + 1)
    bands = torch.from_numpy(g.standard_normal((K, 1, 1, NC))).to(cuda)
    x = torch.from_numpy(g.standard_normal((NC, 1))).to(cuda)
    b = torch.from_numpy(g.standard_normal((NC, 1))).to(cuda)
    dms = tuple(int(d) for d in g.integers(-2 * NC, 2 * NC, K))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        B, X, Bb = (t.to(dtype) for t in (bands, x, b))
        y = bk.banded_apply(B, X, dms, -1.0, Bb)
        assert y.shape == (NC, 1)
        assert _rel_err(y, bk.banded_apply_plain(B, X, dms, -1.0, Bb)) <= tol


def test_kernel_refuses_bad_input(cuda):
    bands = torch.zeros(2, 4, 4, 8, device=cuda)
    with pytest.raises(ValueError):
        bk.banded_apply(bands, torch.zeros(8, 4), (0, 1))       # cpu x
    with pytest.raises(TypeError):
        bk.banded_apply(bands, torch.zeros(8, 4, device=cuda,
                                           dtype=torch.float64), (0, 1))
    with pytest.raises(ValueError):                             # V = 3
        bk.banded_apply(torch.zeros(2, 3, 3, 8, device=cuda),
                        torch.zeros(8, 3, device=cuda), (0, 1))
    with pytest.raises(ValueError):                             # V = 1, x V 4
        bk.banded_apply(torch.zeros(2, 1, 1, 8, device=cuda),
                        torch.zeros(8, 4, device=cuda), (0, 1))


def _bsgs_inputs(dev, dtype, NC, K=bk.MAX_BANDS, seed=0, V=4):
    """Random D^-1 (1, V, V, NC), D^-1 N (K, V, V, NC) scaled so that a
    sweep contracts, shifts normalized into (-NC/2, NC/2] with a duplicate
    (as the O-mesh seam bands have), and v (NC, V)."""
    g = np.random.default_rng(seed + NC)
    dinv = g.standard_normal((1, V, V, NC)) / V
    dn = g.standard_normal((K, V, V, NC)) * (0.5 / (V * K))
    dms = list(tb._norm_offsets(g.integers(-2 * NC, 2 * NC, K), NC))
    if K > 2:
        dms[-1] = dms[1]
    v = g.standard_normal((NC, V))

    def put(a):
        return torch.from_numpy(a).to(dev, dtype)
    return put(dinv), put(dn), tuple(int(d) for d in dms), put(v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("NC", [1, 129, 1000, 12_800, 204_800])
def test_bsgs_fused_equals_sequence(cuda, dtype, NC):
    """Every K 1-8 and sweeps 0-6: one launch, equal to the sequence value
    for value, within TOL of the twin."""
    dinv, dn8, dms8, v = _bsgs_inputs(cuda, dtype, NC)
    for K in range(1, bk.MAX_BANDS + 1):
        dn, dms = dn8[:K], dms8[:K]
        for sweeps in range(7):
            zs = bk.bsgs_sequence(dinv, dn, dms, sweeps)(v)
            zp = bk.bsgs_apply_plain(dinv, dn, dms, sweeps, v)
            f0, n0 = bk.bsgs_apply.launches, bk.banded_apply.launches
            z = bk.bsgs_apply(dinv, dn, dms, sweeps, v)
            torch.cuda.synchronize()
            assert bk.bsgs_apply.launches == f0 + 1
            assert bk.banded_apply.launches == n0
            assert z.shape == (NC, 4) and z.dtype == dtype and z.is_cuda
            assert torch.equal(z, zs), (K, sweeps)
            assert _rel_err(z, zp) <= TOL[dtype], (K, sweeps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("NC", [1, 129, 1000, 12_800, 262_144])
def test_bsgs_fused_equals_sequence_v1(cuda, dtype, NC):
    """1x1 blocks, every K 1-8 and sweeps 0-6: one launch, equal to the
    sequence value for value, within TOL of the twin."""
    dinv, dn8, dms8, v = _bsgs_inputs(cuda, dtype, NC, V=1)
    for K in range(1, bk.MAX_BANDS + 1):
        dn, dms = dn8[:K], dms8[:K]
        for sweeps in range(7):
            zs = bk.bsgs_sequence(dinv, dn, dms, sweeps)(v)
            zp = bk.bsgs_apply_plain(dinv, dn, dms, sweeps, v)
            f0, n0 = bk.bsgs_apply.launches, bk.banded_apply.launches
            z = bk.bsgs_apply(dinv, dn, dms, sweeps, v)
            torch.cuda.synchronize()
            assert bk.bsgs_apply.launches == f0 + 1
            assert bk.banded_apply.launches == n0
            assert z.shape == (NC, 1) and z.dtype == dtype and z.is_cuda
            assert torch.equal(z, zs), (K, sweeps)
            assert _rel_err(z, zp) <= TOL[dtype], (K, sweeps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bsgs_residency_cases_v1(cuda, dtype):
    """1x1 blocks with all cells resident, some, none (forced through the
    plan's shared memory; the shared tier arrives by TMA), and the card's
    own plan at the 512x512 heat equation's 262,144 cells: none (its four
    bands fit in L2)."""
    K, sweeps = 4, 6
    for NC in (12_800, 262_144):
        dinv, dn, dms, v = _bsgs_inputs(cuda, dtype, NC, K, V=1)
        blocks = bk.bsgs_device_limits(cuda)["n_blocks"]
        per_cell = bk.bsgs_cell_bytes(K, dtype, 1)
        a = bk.bsgs_align(dtype)
        chunk = -(-(-(-NC // blocks)) // a) * a
        want = bk.bsgs_sequence(dinv, dn, dms, sweeps)(v)
        for smem, n_res in ((16 + chunk * per_cell, chunk),
                            (16 + chunk // 2 * per_cell, chunk // 2 // a * a),
                            (0, 0)):
            app = bk.BsgsApply(dinv, dn, dms, sweeps, smem_bytes=smem)
            assert app.plan.chunk == chunk and app.plan.n_res == n_res
            assert torch.equal(app(v), want), (NC, n_res)
        app = bk.BsgsApply(dinv, dn, dms, sweeps)
        assert app.plan.n_res == 0 and app.plan.smem_bytes == 0
        assert torch.equal(app(v), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bsgs_residency_cases(cuda, dtype):
    """All cells resident, some, none (forced through the plan's shared
    memory), and the card's own plan: none at 12,800 cells
    (the bands fit in L2), some at 204,800."""
    K, sweeps = 6, 6
    NC = 12_800
    dinv, dn, dms, v = _bsgs_inputs(cuda, dtype, NC, K)
    blocks = bk.bsgs_device_limits(cuda)["n_blocks"]
    per_cell = bk.bsgs_cell_bytes(K, dtype)
    a = bk.bsgs_align(dtype)
    chunk = -(-(-(-NC // blocks)) // a) * a
    want = bk.bsgs_sequence(dinv, dn, dms, sweeps)(v)
    for smem, n_res in ((16 + chunk * per_cell, chunk),
                        (16 + chunk // 2 * per_cell, chunk // 2 // a * a),
                        (0, 0)):
        app = bk.BsgsApply(dinv, dn, dms, sweeps, smem_bytes=smem)
        assert app.plan.chunk == chunk and app.plan.n_res == n_res
        assert app.plan.smem_bytes <= smem
        assert torch.equal(app(v), want), n_res
    app = bk.BsgsApply(dinv, dn, dms, sweeps)
    assert app.plan.n_res == 0 and app.plan.smem_bytes == 0
    assert torch.equal(app(v), want)
    NC = 204_800
    dinv, dn, dms, v = _bsgs_inputs(cuda, dtype, NC, K)
    want = bk.bsgs_sequence(dinv, dn, dms, sweeps)(v)
    app = bk.BsgsApply(dinv, dn, dms, sweeps)
    assert 0 < app.plan.n_res < app.plan.chunk
    assert torch.equal(app(v), want)


def test_bsgs_flags_across_applies(cuda):
    """2,000 applies of one operator back to back on one stream (the flags
    never reset: each apply raises each by the sweeps), each equal to the
    sequence; at 204,800 cells, f32, some cells resident."""
    K, sweeps, NC = 6, 6, 204_800
    dinv, dn, dms, _ = _bsgs_inputs(cuda, torch.float32, NC, K)
    g = torch.Generator(device=cuda).manual_seed(0)
    vs = [torch.randn(NC, 4, device=cuda, generator=g) for _ in range(4)]
    seq = bk.bsgs_sequence(dinv, dn, dms, sweeps)
    wants = [seq(v) for v in vs]
    app = bk.BsgsApply(dinv, dn, dms, sweeps)
    f0 = bk.bsgs_apply.launches
    outs = [app(vs[i % 4]) for i in range(2000)]
    torch.cuda.synchronize()
    assert bk.bsgs_apply.launches == f0 + 2000
    assert bool((app._flags == 2000 * sweeps).all())
    bad = [i for i, z in enumerate(outs) if not torch.equal(z, wants[i % 4])]
    assert not bad, bad[:10]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bsgs_in_a_cuda_graph(cuda, dtype):
    """An apply captured in a CUDA graph, between eager applies of the same
    operator, stays equal to the sequence at every replay (the flags' count
    is read on the card, not fixed at capture); 204,800 cells, some
    resident."""
    K, sweeps, NC = 6, 6, 204_800
    dinv, dn, dms, _ = _bsgs_inputs(cuda, dtype, NC, K)
    g = torch.Generator(device=cuda).manual_seed(1)
    vs = [torch.randn(NC, 4, device=cuda, dtype=dtype, generator=g)
          for _ in range(3)]
    seq = bk.bsgs_sequence(dinv, dn, dms, sweeps)
    wants = [seq(v) for v in vs]
    app = bk.BsgsApply(dinv, dn, dms, sweeps)
    assert 0 < app.plan.n_res < app.plan.chunk
    static_v = vs[0].clone()
    app(static_v)              # sets the kernel's attributes before capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_z = app(static_v)
    for i in range(60):
        static_v.copy_(vs[i % 3])
        graph.replay()
        assert torch.equal(static_z, wants[i % 3]), i
        if i % 7 == 0:                     # eager applies in between
            assert torch.equal(app(vs[(i + 1) % 3]), wants[(i + 1) % 3]), i
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("NC", [129, 12_800, 204_800])
def test_bsgs_skips_bands_outside_their_support(cuda, dtype, NC):
    """Bands zero outside a cell range (as the O-mesh seam bands are), with
    their supports given: the kernel skips them there and keeps only the
    dense bands on chip, and still equals the sequence."""
    K, sweeps = 6, 6
    dinv, dn, dms, v = _bsgs_inputs(cuda, dtype, NC, K)
    ring = max(NC // 40, 1)
    support = [(0, NC)] * 4 + [(0, ring), (NC - ring, NC)]
    support[2] = (ring, NC)
    for k, (lo, hi) in enumerate(support):
        dn[k, :, :, :lo] = 0
        dn[k, :, :, hi:] = 0
    want = bk.bsgs_sequence(dinv, dn, dms, sweeps)(v)
    for smem in (None, 0):
        app = bk.BsgsApply(dinv, dn, dms, sweeps, support, smem_bytes=smem)
        assert torch.equal(app(v), want), smem
    assert app.plan.n_res == 0
    per_cell = bk.bsgs_cell_bytes(4, dtype)
    app = bk.BsgsApply(dinv, dn, dms, sweeps, support)
    p = app.plan
    lim = bk.bsgs_device_limits(cuda)
    room = (lim["smem_per_block"] - 16) // per_cell
    a = bk.bsgs_align(dtype)
    dense = bk.bsgs_dense_bands(support, NC)
    fits = bk.bsgs_bands_fit_l2(support, dense, dtype, lim["l2_bytes"])
    assert fits == (NC < 204_800)
    assert p.n_res == (0 if fits else min(p.chunk, room) // a * a)
    assert torch.equal(app(v), want)
    with pytest.raises(ValueError):
        bk.BsgsApply(dinv, dn, dms, sweeps, support[:5])
    with pytest.raises(ValueError):
        bk.BsgsApply(dinv, dn, dms, sweeps, [(0, NC + 1)] * 6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("NC", [129, 12_800, 262_144])
def test_bsgs_skips_bands_outside_their_support_v1(cuda, dtype, NC):
    """1x1 bands zero outside a cell range, with their supports given: the
    kernel skips them there, with and without a shared tier, and still
    equals the sequence."""
    K, sweeps = 6, 6
    dinv, dn, dms, v = _bsgs_inputs(cuda, dtype, NC, K, V=1)
    ring = max(NC // 40, 1)
    support = [(0, NC)] * 4 + [(0, ring), (NC - ring, NC)]
    support[2] = (ring, NC)
    for k, (lo, hi) in enumerate(support):
        dn[k, :, :, :lo] = 0
        dn[k, :, :, hi:] = 0
    want = bk.bsgs_sequence(dinv, dn, dms, sweeps)(v)
    per_cell = bk.bsgs_cell_bytes(4, dtype, 1)
    for smem in (None, 0, 16 + 64 * per_cell):
        app = bk.BsgsApply(dinv, dn, dms, sweeps, support, smem_bytes=smem)
        assert torch.equal(app(v), want), smem
    assert app.plan.n_res == min(64, app.plan.chunk) // bk.bsgs_align(
        dtype) * bk.bsgs_align(dtype)
    with pytest.raises(ValueError):
        bk.BsgsApply(dinv, dn, dms, sweeps, support[:5])


def test_bsgs_refuses_bad_input(cuda):
    """Bad operands raise before a launch; a grid or shared memory the card
    cannot take makes the launch fail, and the wrapper raises (no fallback
    to the sequence or the twin)."""
    dinv, dn, dms, v = _bsgs_inputs(cuda, torch.float32, 12_800, 6)
    with pytest.raises(ValueError):
        bk.bsgs_apply(dinv, dn, dms, 6, v.cpu())             # v on the host
    with pytest.raises(TypeError):
        bk.bsgs_apply(dinv, dn, dms, 6, v.double())          # mixed dtypes
    with pytest.raises(ValueError):
        bk.bsgs_apply(dinv, dn, dms, -1, v)                  # sweeps < 0
    with pytest.raises(ValueError):
        bk.bsgs_apply(dinv, dn, dms[:5], 6, v)               # a shift short
    with pytest.raises(ValueError):
        bk.bsgs_apply(dinv[:, :, :, :-1], dn, dms, 6, v)     # dinv's NC
    d3, n3, m3, v3 = _bsgs_inputs(cuda, torch.float32, 129, 4, V=3)
    with pytest.raises(ValueError):
        bk.bsgs_apply(d3, n3, m3, 6, v3)                     # V = 3
    d1, n1, m1, v1 = _bsgs_inputs(cuda, torch.float32, 129, 4, V=1)
    with pytest.raises(ValueError):
        bk.bsgs_apply(d1, n1, m1, 6, v1.expand(129, 4).contiguous())
    n0 = bk.bsgs_apply.launches
    with pytest.raises(RuntimeError):
        bk.bsgs_apply(dinv, dn, dms, 6, v, n_blocks=12_800)  # grid too large
    with pytest.raises(RuntimeError):
        bk.bsgs_apply(dinv, dn, dms, 6, v, n_blocks=1,
                      smem_bytes=1 << 30)                    # smem too large
    assert bk.bsgs_apply.launches == n0
    z = bk.bsgs_apply(dinv, dn, dms, 6, v)                   # still launches
    assert torch.equal(z, bk.bsgs_sequence(dinv, dn, dms, 6)(v))


def _basis(g, rows, n, dtype, dev):
    V = torch.from_numpy(g.standard_normal((rows, n))).to(dev, dtype)
    w = torch.from_numpy(g.standard_normal(n)).to(dev, dtype)
    return V, w


def _assert_row_set(V, j, w, hn):
    """row_set(V, j, w, hn) is one launch, in place, and leaves V equal bit
    for bit (NaN for NaN) to its twin's result: row j set, the rest as
    they were."""
    want = rk.rowset_plain(V.clone(), j, w, hn)
    ptr, n0 = V.data_ptr(), rk.row_set.launches
    assert rk.row_set(V, j, w, hn) is V
    torch.cuda.synchronize()
    assert rk.row_set.launches == n0 + 1 and V.data_ptr() == ptr
    assert torch.equal(V.isnan(), want.isnan())
    assert torch.equal(V.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,j", [(1, 0), (3, 2), (4, 1), (5, 3), (1023, 7),
                                 (1000, 5), (262_528, 95), (819_200, 1)])
def test_row_set_matches_twin_bit_for_bit(cuda, dtype, n, j):
    """Any n (262,528: where the TPU kernel's tile gate refuses the row;
    n = 3, 5, 1023: rows that start off a 16-byte boundary, with a scalar
    head and tail), any row of the (96, n) basis; in place, one launch."""
    g = np.random.default_rng(n + j)
    V, w = _basis(g, 96, n, dtype, cuda)
    _assert_row_set(V, j, w, torch.sqrt(torch.sum(w * w)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1001, 4099, 65_537])
def test_row_set_misaligned_rows(cuda, dtype, n):
    """Odd row lengths: every row of the basis starts at another offset
    from a 16-byte boundary. w is either a fresh tensor (aligned, so its
    alignment differs from the row's and it is read with scalar loads) or
    a row of another basis of the same shape (the same offset as the
    row)."""
    g = np.random.default_rng(n)
    V, _ = _basis(g, 8, n, dtype, cuda)
    W, w = _basis(g, 8, n, dtype, cuda)
    for j in range(8):
        for wj in (w, W[j]):
            _assert_row_set(V, j, wj, torch.sqrt(torch.sum(wj * wj)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("hn", [0.0, float("nan"), float("inf")])
def test_row_set_special_norms(cuda, dtype, hn):
    """A zero norm is clamped at 1e-300 in f64 and at 0 in f32, a NaN norm
    stays NaN and an infinite one gives zeros (NaN where w is infinite),
    as in the twin; w holds zeros and infinities too."""
    g = np.random.default_rng(7)
    for n in (5, 819_200):
        V, w = _basis(g, 16, n, dtype, cuda)
        w[0] = 0.0
        w[-1] = float("inf")
        _assert_row_set(V, 3, w, torch.tensor(hn, device=cuda, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_set_strided_row_and_norm_clamp(cuda, dtype):
    """A row of a column slice (row stride 1100 > n = 1000) leaves the rest
    of the storage alone; a zero norm is clamped at 1e-300 in f64 and at 0
    in f32, and a NaN norm stays NaN, as in the twin."""
    g = np.random.default_rng(3)
    big = torch.zeros(8, 1100, device=cuda, dtype=dtype)
    V = big[:, 50:1050]
    w = torch.from_numpy(g.standard_normal(1000)).to(cuda, dtype)
    w[7] = 0.0
    rk.row_set(V, 3, w, torch.tensor(4.0, device=cuda, dtype=dtype))
    torch.cuda.synchronize()
    assert torch.equal(big[3, 50:1050], w / 4.0)
    assert not big[:, :50].any() and not big[:, 1050:].any()
    assert not big[:3].any() and not big[4:].any()
    for hn in (0.0, float("nan")):
        h = torch.tensor(hn, device=cuda, dtype=dtype)
        rk.row_set(V, 5, w, h)
        want = rk.rowset_plain(V.clone(), 5, w, h)
        torch.cuda.synchronize()
        assert torch.allclose(V, want, rtol=0.0, atol=0.0, equal_nan=True)
    assert torch.isnan(V[5]).all()


def test_row_set_refuses_bad_input(cuda):
    V = torch.zeros(8, 16, device=cuda)
    w = torch.zeros(16, device=cuda)
    hn = torch.ones((), device=cuda)
    with pytest.raises(ValueError):
        rk.row_set(V, 0, w.cpu(), hn)                  # w on the host
    with pytest.raises(ValueError):
        rk.row_set(V, 0, w, hn.cpu())                  # hn on the host
    with pytest.raises(TypeError):
        rk.row_set(V, 0, w.double(), hn)               # mixed dtypes
    with pytest.raises(TypeError):
        rk.row_set(V.half(), 0, w.half(), hn.half())   # unsupported dtype
    with pytest.raises(ValueError):
        rk.row_set(V, 0, w[:15], hn)                   # wrong length
    with pytest.raises(ValueError):
        rk.row_set(V, 8, w, hn)                        # row out of range
    with pytest.raises(ValueError):
        rk.row_set(torch.zeros(16, 8, device=cuda).T, 0, w, hn)
