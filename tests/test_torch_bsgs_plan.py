"""The fused bsgs kernel's launch plan and its schedule, on the CPU.

The kernel (csrc/banded_bsgs.cu) runs D^-1 v and the sweeps as phases of
one launch; block b starts phase p once every block of its waits(b) has
finished phase p - 1 (per-block flags, no grid barrier), and the phases
write three buffers in turn (dv, then z and out by the parity rule). Here:
  - the plan's deps/waits sets against a brute force over every cell, on
    the band structures of the 640x320 and 160x80 cylinder O-meshes and on
    synthetic offsets (wrap-around, offsets larger than a block's range,
    bands confined to a few cells); on the 640x320 O-mesh each block waits
    for its two neighbours only, the seam bands closing the ring;
  - the block's shared-memory tier: 16-byte runs, within the shared
    memory given, as many as fit, with 4x4 blocks and with the heat
    equation's 1x1 blocks (unit_square(16) and (512): whose bands fit in
    L2, so the card's plan keeps no shared tier there);
  - a schedule simulator in plain PyTorch: the phases run block by block
    in seeded random orders that respect only the plan's waits, on the
    kernel's three buffers. It equals bsgs_apply_plain bit for bit at f64
    (the same products in the same order, slice by slice). With waits cut
    to deps (without the reverse set) a block may overwrite z that a
    neighbour has yet to read, and the simulator sees it.

The cluster design at 1x1 blocks (csrc/banded_bsgs_cluster.cu) has a plan
of its own (bsgs_cluster_plan): each cluster of C CTAs computes its owned
cells from a window widened by sweeps * max|shift| cells, cut into C
16-byte-aligned slices. Here:
  - the plan on unit_square(16), (64), (256) and (512) with an H100's
    limits (as the card reported them): windows, slices, shared memory;
    it refuses the O-mesh (whose seam bands wrap), a synthetic wrapping
    band, slices beyond the shared memory and cluster sizes the card does
    not take; the design BsgsApply takes from it (bsgs_design);
  - a cluster schedule simulator in plain PyTorch: clusters in seeded
    random order, each cluster's sweeps in lock-step on per-CTA slice
    buffers (D^-1 v and two z buffers, NaN outside the window), each CTA
    pushing the cells near its slice's ends into its neighbours' ghost
    cells by the kernel's index rule. It equals bsgs_apply_plain bit for
    bit at f64; with the halo cut by one shift, NaN reaches the output.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fvens_tpu_torch.cases import bigmesh_case
from fvens_tpu_torch.cases import model_problems as mp
from fvens_tpu_torch.solver import banded as tb
from fvens_tpu_torch.solver import banded_kernels as bk

# what the plan gives a block on an H100: the SM's 228 KB of shared memory
# less the 1 KB the system keeps and the 32 KB left to L1
H100_SMEM = 233_472 - 1024 - bk.BSGS_L1_BYTES
H100_SMS = 132


# what an NVIDIA H100 80GB HBM3 reported for the cluster kernel
# (bsgs_cluster_limits: the opt-in shared memory, and the clusters of each
# size cudaOccupancyMaxActiveClusters gives at it)
H100_CLUSTER_LIMITS = dict(smem_optin=232_448,
                           max_clusters={1: 132, 2: 66, 4: 30, 8: 15, 16: 7})


@pytest.fixture(scope="module")
def omesh_structures():
    """{(ni, nj): (NC, normalized shifts, supports)} of the cylinder
    O-meshes (bigmesh_case's meshes)."""
    out = {}
    for ni, nj in ((640, 320), (160, 80)):
        _, cm, _ = bigmesh_case.build_case(torch.device("cpu"), ni, nj)
        bl = tb.banded_structure(cm)
        out[(ni, nj)] = (cm.NC, tb._norm_offsets(bl.offsets, cm.NC),
                         bl.support)
    return out


@pytest.fixture(scope="module")
def heat_structures():
    """{n: (NC, normalized shifts, supports)} of the heat equation's
    unit_square(n) (1x1 blocks)."""
    out = {}
    for n in (16, 64, 256, 512):
        _, mesh = mp.heat_solver("cpu", n, False, banded=True)
        bl = tb.banded_structure(mesh)
        out[n] = (mesh.NC, tb._norm_offsets(bl.offsets, mesh.NC), bl.support)
    return out


def _deps_brute(NC, chunk, blocks, dms, support):
    """deps by cell: the owners of (c + d) mod NC, c in band k's support."""
    deps = [set() for _ in range(blocks)]
    for d, (lo, hi) in zip(dms, support):
        c = np.arange(lo, hi)
        pairs = np.unique((c // chunk) * blocks + (c + d) % NC // chunk)
        for b, o in zip(pairs // blocks, pairs % blocks):
            if b != o:
                deps[b].add(int(o))
    return tuple(tuple(sorted(s)) for s in deps)


def _plan(NC, support, dtype, smem=H100_SMEM, n_blocks=H100_SMS, V=4):
    dense = bk.bsgs_dense_bands(support, NC)
    return bk.bsgs_launch_plan(NC, sum(dense), dtype, smem, n_blocks, V)


@pytest.mark.parametrize("V", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cell_bytes(V, dtype):
    """A resident cell: V * V entries of each band kept on chip and V of
    D^-1 v (at K = 4: 272 bytes at V = 4, 20 at V = 1, in f32)."""
    it = 4 if dtype == torch.float32 else 8
    for K in range(bk.MAX_BANDS + 1):
        assert bk.bsgs_cell_bytes(K, dtype, V) == (K * V * V + V) * it
    assert bk.bsgs_cell_bytes(4, torch.float32, V) == {1: 20, 4: 272}[V]


@pytest.mark.parametrize("n", [16, 512])
def test_heat_waits_are_the_neighbours(heat_structures, n):
    """unit_square(n), 1x1 blocks, shifts (-n, -1, 1, n): deps equals the
    brute force. No band wraps (each band's support stops short of the
    wrap), so at 512x512 (1,988 cells a block at f32, 1,986 at f64, more
    than n) each block waits for the blocks beside it only, the first and
    the last for one."""
    NC, dms, support = heat_structures[n]
    assert dms == (-n, -1, 1, n)
    for dtype in (torch.float32, torch.float64):
        p = _plan(NC, support, dtype, V=1)
        deps = bk.bsgs_block_deps(NC, p.chunk, p.blocks, dms, support)
        assert deps == _deps_brute(NC, p.chunk, p.blocks, dms, support)
        waits = bk.bsgs_block_waits(deps)
        if n == 512:
            B = p.blocks
            assert (B, p.chunk) == ((132, 1988) if dtype == torch.float32
                                    else (132, 1986))
            assert [set(w) for w in waits] == [
                {o for o in (b - 1, b + 1) if 0 <= o < B} for b in range(B)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_heat_shared_tier_v1(heat_structures, dtype):
    """At 512x512 the four 1x1 bands (8.4 MB at f64) fit in half of an
    H100's L2, so the plan keeps none in shared memory; given an H100's
    shared memory a block keeps all its cells (20 bytes a cell at f32, 40
    at f64), in 16-byte runs."""
    NC, _, support = heat_structures[512]
    dense = bk.bsgs_dense_bands(support, NC)
    assert dense == (True,) * 4
    assert bk.bsgs_bands_fit_l2(support, dense, dtype, 50 * 1024 * 1024, 1)
    assert not bk.bsgs_bands_fit_l2(support, dense, dtype, 50 * 1024 * 1024)
    p = _plan(NC, support, dtype, V=1)
    assert p.n_res == p.chunk and p.chunk % bk.bsgs_align(dtype) == 0
    assert p.smem_bytes == 16 + p.chunk * bk.bsgs_cell_bytes(4, dtype, 1)
    q = _plan(NC, support, dtype, smem=16 + 1001 * bk.bsgs_cell_bytes(
        4, dtype, 1), V=1)
    assert q.n_res == 1000 and q.chunk == p.chunk


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mesh", [(640, 320), (160, 80)])
def test_omesh_waits_are_the_neighbours(omesh_structures, mesh, dtype):
    NC, dms, support = omesh_structures[mesh]
    p = _plan(NC, support, dtype)
    deps = bk.bsgs_block_deps(NC, p.chunk, p.blocks, dms, support)
    assert deps == _deps_brute(NC, p.chunk, p.blocks, dms, support)
    waits = bk.bsgs_block_waits(deps)
    B = p.blocks
    ring = [{(b - 1) % B, (b + 1) % B} for b in range(B)]
    assert all(ring[b] <= set(w) for b, w in enumerate(waits))
    if mesh == (640, 320):
        # 1,552 cells a block: the +-1 and +-nj bands reach the next block
        # only, and the seam bands (one ring of 320 cells) join the first
        # and the last block
        assert p.chunk == 1552 and B == 132
        assert [set(w) for w in waits] == ring
    else:
        # the seam ring of 80 cells may straddle two blocks at either end
        extra = [set(w) - ring[b] for b, w in enumerate(waits)]
        assert all(not e for e in extra[2:-2])
        assert max(len(w) for w in waits) <= 4


def test_synthetic_deps_and_waits():
    """Random shifts in (-2 NC, 2 NC), wrap-around, shifts beyond a block,
    zero shifts and bands confined to a few cells: deps equals the brute
    force, waits is deps made symmetric, and no block lists itself."""
    g = np.random.default_rng(7)
    for trial in range(60):
        NC = int(g.integers(1, 3000))
        K = int(g.integers(1, bk.MAX_BANDS + 1))
        n_blocks = int(g.integers(1, 140))
        dms = tuple(int(d) for d in g.integers(-2 * NC, 2 * NC, K))
        if trial % 3 == 0:
            dms = dms[:-1] + (0,)
        support = []
        for _ in range(K):
            lo = int(g.integers(0, NC + 1))
            hi = int(g.integers(lo, NC + 1))
            support.append((lo, hi) if trial % 2 else (0, NC))
        p = bk.bsgs_launch_plan(NC, K, torch.float64, 0, n_blocks)
        deps = bk.bsgs_block_deps(NC, p.chunk, p.blocks, dms, support)
        assert deps == _deps_brute(NC, p.chunk, p.blocks, dms, support)
        waits = bk.bsgs_block_waits(deps)
        for b, w in enumerate(waits):
            assert b not in w
            assert set(w) == set(deps[b]) | {o for o in range(p.blocks)
                                             if b in deps[o]}
            # a block's range meets at most two blocks once shifted, three
            # where it wraps past the short last block
            assert len(w) <= 6 * K
        table = bk._waits_table(waits)
        for b, w in enumerate(waits):
            assert tuple(table[table[b]:table[b + 1]]) == w


def test_waits_are_computed_once_per_plan(omesh_structures):
    """The operator is rebuilt every Newton step; its waits and their table
    on the device are looked up, computed only for a new mesh or plan."""
    NC, dms, support = omesh_structures[(160, 80)]
    dev = torch.device("cpu")
    p = _plan(NC, support, torch.float32)
    waits, table = bk._block_waits(dev, NC, p, dms, support)
    assert waits == bk.bsgs_block_waits(
        bk.bsgs_block_deps(NC, p.chunk, p.blocks, dms, support))
    assert table.dtype == torch.int32
    assert table.tolist() == bk._waits_table(waits)
    again = bk._block_waits(dev, NC, p, tuple(dms), tuple(support))
    assert again[0] is waits and again[1] is table
    q = _plan(NC, support, torch.float32, n_blocks=64)
    assert bk._block_waits(dev, NC, q, dms, support)[1] is not table


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_omesh_shared_tier(omesh_structures, dtype):
    """The 640x320 plan on an H100's 132 SMs and 199,680 bytes: 732 of each
    block's 1,552 cells keep their four dense bands and base in shared
    memory at f32 (272 bytes a cell), 366 at f64; 16-byte runs."""
    NC, _, support = omesh_structures[(640, 320)]
    p = _plan(NC, support, dtype)
    assert (p.blocks, p.chunk) == (132, 1552)
    assert H100_SMEM == 199_680
    assert p.n_res == (732 if dtype == torch.float32 else 366)
    assert p.smem_bytes == 16 + p.n_res * bk.bsgs_cell_bytes(4, dtype)
    assert p.smem_bytes <= H100_SMEM


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_shared_tier_only_where_the_bands_outgrow_l2(omesh_structures,
                                                     dtype):
    """On an H100's 50 MB L2 the 160x80 mesh's dense bands (3.3 MB at f32)
    fit in half of it, so the kernel keeps none in shared memory; the
    640x320 mesh's (52.4 MB at f32) do not."""
    l2 = 50 * 1024 * 1024
    for mesh, fits in (((160, 80), True), ((640, 320), False)):
        NC, _, support = omesh_structures[mesh]
        dense = bk.bsgs_dense_bands(support, NC)
        assert bk.bsgs_bands_fit_l2(support, dense, dtype, l2) == fits
    NC, _, support = omesh_structures[(160, 80)]
    dense = bk.bsgs_dense_bands(support, NC)
    nbytes = sum(hi - lo for (lo, hi), d in zip(support, dense) if d) \
        * 16 * bk._itemsize(dtype)
    assert bk.bsgs_bands_fit_l2(support, dense, dtype, 2 * nbytes)
    assert not bk.bsgs_bands_fit_l2(support, dense, dtype, 2 * nbytes - 1)


@pytest.mark.parametrize("V", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_shared_tier_is_aligned_and_full(dtype, V):
    """Every block start and the shared tier a whole number of 16-byte
    runs; as many runs as the shared memory holds after its 16-byte
    header, never past the block's range; no shared memory asked for
    without a shared tier."""
    a = bk.bsgs_align(dtype)
    assert a == (4 if dtype == torch.float32 else 2)
    for NC in (1, 3, 129, 1000, 12_800, 204_800):
        for K in (0, 4, 8):
            per_cell = bk.bsgs_cell_bytes(K, dtype, V)
            for n_blocks in (1, 132, 1000):
                for smem in (0, 16 + per_cell - 1, 48 * 1024, H100_SMEM):
                    p = bk.bsgs_launch_plan(NC, K, dtype, smem, n_blocks, V)
                    assert p.chunk % a == 0 and p.n_res % a == 0
                    assert p.n_res <= p.chunk
                    assert p.smem_bytes == (16 + p.n_res * per_cell
                                            if p.n_res else 0)
                    assert p.smem_bytes <= max(smem, 0)
                    assert p.chunk - p.n_res < a or (
                        16 + (p.n_res + a) * per_cell > smem)


# ---------------------------------------------------------------------------
# the schedule simulator
# ---------------------------------------------------------------------------

def _phase_buffers(sweeps):
    """(read, write) buffer of each phase, as the kernel assigns them: phase
    0 writes dv (out when there are no sweeps); sweep s reads the previous
    phase's buffer and writes out when sweeps - s is even, else z, so the
    last sweep lands in out."""
    write = ["out" if sweeps == 0 else "dv"]
    for s in range(1, sweeps + 1):
        write.append("out" if (sweeps - s) % 2 == 0 else "z")
    return [(None, write[0])] + [(write[s - 1], write[s])
                                 for s in range(1, sweeps + 1)]


def simulate(dinv, dn, dms, sweeps, v, chunk, blocks, waits, seed,
             support):
    """The fused apply as the kernel schedules it: an event is one block's
    phase, which may run once every block of waits(b) has finished the
    previous phase (phase 0 at once); it runs banded.bsgs_sweeps's
    arithmetic on the block's cells (band k skipped outside its support,
    as the kernel skips it). Events run in a random order among those the
    waits allow. Buffers start as NaN, so a read of a value not yet
    written shows."""
    NC, V = v.shape
    g = np.random.default_rng(seed)
    Dt, vt = dinv[0], v.T
    bufs = {n: torch.full((V, NC), float("nan"), dtype=v.dtype)
            for n in ("dv", "z", "out")}
    rw = _phase_buffers(sweeps)
    done = [-1] * blocks
    while min(done) < sweeps:
        ready = [b for b in range(blocks) if done[b] < sweeps
                 and all(done[w] >= done[b] for w in waits[b])]
        b = int(g.choice(ready))
        p = done[b] + 1
        cells = torch.arange(b * chunk, min((b + 1) * chunk, NC))
        src, dst = rw[p]
        if p == 0:
            bufs[dst][:, cells] = tb._block_mv(Dt[:, :, cells], vt[:, cells])
        else:
            acc = bufs["dv"][:, cells]
            for k, (d, (lo, hi)) in enumerate(zip(dms, support)):
                m = (cells >= lo) & (cells < hi)
                c = cells[m]
                acc[:, m] = acc[:, m] - tb._block_mv(
                    dn[k][:, :, c], bufs[src][:, (c + d) % NC])
            bufs[dst][:, cells] = acc
        done[b] = p
    return bufs["out"].T


def _inputs(NC, K, seed, support=None, V=4):
    g = np.random.default_rng(seed)
    dinv = torch.from_numpy(g.standard_normal((1, V, V, NC)) / V)
    dn = torch.from_numpy(g.standard_normal((K, V, V, NC)) * (0.5 / (V * K)))
    for k, (lo, hi) in enumerate(support or ()):
        dn[k, :, :, :lo] = 0
        dn[k, :, :, hi:] = 0
    return dinv, dn, torch.from_numpy(g.standard_normal((NC, V)))


def _case(name, omesh_structures, heat_structures):
    """(NC, shifts, support, n_blocks, V) of a simulated case."""
    if name == "cylinder 160x80":
        NC, dms, support = omesh_structures[(160, 80)]
        return NC, dms, support, H100_SMS, 4
    if name == "heat 16, 1x1 blocks":
        NC, dms, support = heat_structures[16]
        return NC, dms, support, 9, 1
    g = np.random.default_rng(3)
    NC = 997
    dms = tuple(int(d) for d in tb._norm_offsets(
        g.integers(-3 * NC, 3 * NC, 6), NC)) + (0, 130)
    support = ((0, NC),) * 5 + ((10, 40), (0, NC), (500, 997))
    return NC, dms, support, 23, 4


@pytest.mark.parametrize("sweeps", [0, 1, 2, 6])
@pytest.mark.parametrize("name", ["cylinder 160x80", "synthetic",
                                  "heat 16, 1x1 blocks"])
def test_schedule_equals_the_twin(omesh_structures, heat_structures, name,
                                  sweeps):
    NC, dms, support, n_blocks, V = _case(name, omesh_structures,
                                          heat_structures)
    dinv, dn, v = _inputs(NC, len(dms), seed=sweeps, support=support, V=V)
    p = bk.bsgs_launch_plan(NC, 4, torch.float64, H100_SMEM, n_blocks, V)
    waits = bk.bsgs_block_waits(bk.bsgs_block_deps(NC, p.chunk, p.blocks,
                                                   dms, support))
    want = bk.bsgs_apply_plain(dinv, dn, dms, sweeps, v)
    for seed in range(3):
        z = simulate(dinv, dn, dms, sweeps, v, p.chunk, p.blocks, waits,
                     seed, support)
        assert torch.equal(z, want), seed


def test_schedule_without_the_reverse_waits_differs():
    """Each block reads the next block's z only (one band at +chunk), so
    deps(b) = {b + 1}: waiting for deps alone lets block b + 1 run two
    phases ahead and overwrite the z block b has yet to read. Some seeded
    order shows it; with the full waits every order equals the twin."""
    NC, n_blocks, sweeps = 400, 20, 6
    p = bk.bsgs_launch_plan(NC, 1, torch.float64, 0, n_blocks)
    dms, support = (p.chunk,), ((0, NC),)
    dinv, dn, v = _inputs(NC, 1, seed=11)
    deps = bk.bsgs_block_deps(NC, p.chunk, p.blocks, dms, support)
    assert deps == tuple(((b + 1) % p.blocks,) for b in range(p.blocks))
    want = bk.bsgs_apply_plain(dinv, dn, dms, sweeps, v)
    waits = bk.bsgs_block_waits(deps)
    same = [torch.equal(simulate(dinv, dn, dms, sweeps, v, p.chunk, p.blocks,
                                 w, seed, support), want)
            for w in (waits, deps) for seed in range(8)]
    assert all(same[:8])
    assert not all(same[8:])


# ---------------------------------------------------------------------------
# the cluster design at 1x1 blocks
# ---------------------------------------------------------------------------

def _check_cluster_plan(p, NC, dms, sweeps, dtype):
    """The plan's windows and slices as the kernel computes them."""
    a = bk.bsgs_align(dtype)
    h = max(abs(d) for d in dms)
    assert (p.NC, p.align, p.sweeps, p.reach) == (NC, a, sweeps, h)
    assert p.halo == sweeps * h
    assert p.owned % a == 0 and p.slice % a == 0
    assert p.clusters == -(-NC // p.owned)
    assert (p.clusters - 1) * p.owned < NC <= p.clusters * p.owned
    assert p.ghost % a == 0 and h <= p.ghost < h + a
    assert p.smem_bytes == 16 + (len(dms) * p.slice + 3 * (
        p.slice + 2 * p.ghost)) * bk._itemsize(dtype) <= 232_448
    for g in range(p.clusters):
        w0, w1 = p.window(g)
        assert (w0, w1) == (max(0, g * p.owned - sweeps * h),
                            min(NC, (g + 1) * p.owned + sweeps * h))
        sl = p.slices(g)
        assert len(sl) == p.cluster
        assert sl[0][0] == w0 // a * a
        assert sl[-1][1] == -(-w1 // a) * a
        for j, (s0, s1) in enumerate(sl):
            assert s0 % a == 0 and s1 % a == 0 and 0 <= s1 - s0 <= p.slice
            assert j == 0 or s0 == sl[j - 1][1]
            assert s1 - s0 == p.slice or s1 == sl[-1][1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [16, 64, 256, 512])
def test_cluster_plan_on_the_heat_equation(heat_structures, n, dtype):
    """unit_square(n), shifts (-n, -1, 1, n), no band wraps: the plan takes
    clusters of 8 (the first size the card takes), at most as many as the
    card holds at once (15), for sweeps 0-6. At 512x512 and 6 sweeps each owns
    17,480 cells at f32 (17,478 at f64), a window of at most 23,624, so
    2,956 (2,954) cells a CTA, with 512 ghosts on either side of its D^-1 v
    and z buffers, in 95,072 (190,016) bytes of shared memory."""
    NC, dms, support = heat_structures[n]
    for sweeps in range(7):
        p = bk.bsgs_cluster_plan(NC, dms, support, sweeps, dtype,
                                 H100_CLUSTER_LIMITS)
        assert p is not None and p.cluster == 8
        assert p.clusters <= min(15, -(-NC // bk.bsgs_align(dtype)))
        assert p.clusters == 15 or n < 512
        _check_cluster_plan(p, NC, dms, sweeps, dtype)
    if n == 512:
        f32 = dtype == torch.float32
        assert (p.owned, p.slice, p.smem_bytes) == (
            (17_480, 2_956, 95_072) if f32 else (17_478, 2_954, 190_016))


def test_cluster_plan_refuses_wrapping_bands(omesh_structures):
    """The 160x80 O-mesh: its seam bands read across the wrap, so there is
    no cluster plan (the cooperative kernel runs it). A synthetic band
    that reaches the wrap by one cell has none either; one short of it
    does."""
    NC, dms, support = omesh_structures[(160, 80)]
    assert bk.bsgs_cluster_plan(NC, dms, support, 6, torch.float64,
                                H100_CLUSTER_LIMITS) is None
    NC, lim = 1000, H100_CLUSTER_LIMITS
    for sup, ok in ((((5, NC), (0, NC - 3)), True),
                    (((4, NC), (0, NC - 3)), False),
                    (((5, NC), (0, NC - 2)), False),
                    (((5, NC), (10, 10)), True),       # an empty band
                    (None, False)):                   # every cell
        p = bk.bsgs_cluster_plan(NC, (-5, 3), sup, 6, torch.float64, lim)
        assert (p is not None) == ok, sup


def test_cluster_plan_refuses_what_does_not_fit(heat_structures):
    """No plan where a slice outgrows the shared memory a block may opt in
    to, or for a cluster size the card does not take; a forced size it
    takes is kept; at 512x512 clusters of 16 (7 of them) fit too."""
    NC, dms, support = heat_structures[512]
    lim = dict(H100_CLUSTER_LIMITS, smem_optin=100_000)
    assert bk.bsgs_cluster_plan(NC, dms, support, 6, torch.float64,
                                lim) is None
    assert bk.bsgs_cluster_plan(NC, dms, support, 6, torch.float32,
                                lim) is not None
    none16 = dict(H100_CLUSTER_LIMITS, max_clusters={8: 15, 16: 0})
    assert bk.bsgs_cluster_plan(NC, dms, support, 6, torch.float64, none16,
                                cluster=16) is None
    p = bk.bsgs_cluster_plan(NC, dms, support, 6, torch.float64,
                             H100_CLUSTER_LIMITS, cluster=16)
    assert (p.cluster, p.clusters) == (16, 7)
    _check_cluster_plan(p, NC, dms, 6, torch.float64)
    # 2 CTAs a cluster: 66 clusters of 3,972 cells and their 6,144-cell
    # halo do not fit at f64
    assert bk.bsgs_cluster_plan(NC, dms, support, 6, torch.float64,
                                H100_CLUSTER_LIMITS, cluster=2) is None


def test_bsgs_design(heat_structures, omesh_structures):
    """The cluster design at 1x1 blocks where the plan gives one, else the
    cooperative one; design= forces either (the cluster design raises where
    it has no plan), smem_bytes= / n_blocks= choose the cooperative one,
    and contradictory or unknown choices raise."""
    NC, dms, support = heat_structures[64]
    lim, f64 = H100_CLUSTER_LIMITS, torch.float64

    def design(V=1, sup=support, **kw):
        return bk.bsgs_design(V, NC, dms, sup, 6, f64, lim, **kw)
    d, p = design()
    assert d == "cluster" and p == bk.bsgs_cluster_plan(NC, dms, support, 6,
                                                        f64, lim)
    assert design(cluster=16)[1].cluster == 16
    assert design(design="cooperative") == ("cooperative", None)
    assert design(coop_overrides=True) == ("cooperative", None)
    assert design(V=4) == ("cooperative", None)
    wrap = ((0, NC),) * 4
    assert design(sup=wrap) == ("cooperative", None)
    for kw in (dict(sup=wrap, design="cluster"), dict(V=4, design="cluster"),
               dict(design="cooperative", cluster=8),
               dict(design="cluster", coop_overrides=True),
               dict(design="fused")):
        with pytest.raises(ValueError):
            design(**kw)


def _cells(a, b):
    """The cells [a, b), none where b <= a."""
    return torch.arange(a, max(a, b))


def _push_ghosts(buf, j, r0, y, L, G):
    """The kernel's push_ghost: cells r0 of CTA j's slice (values y) into
    buf's ghosts of the CTAs whose ghost regions hold them (rank j - d at
    r0 + d L where r0 + (d - 1) L < G, rank j + d at r0 - d L where
    r0 >= d L - G)."""
    C = buf.shape[0]
    d = 1
    while (d - 1) * L < G:
        m = r0 + (d - 1) * L < G
        if j - d >= 0:
            buf[j - d, G + r0[m] + d * L] = y[m]
        m = r0 >= d * L - G
        if j + d < C:
            buf[j + d, G + r0[m] - d * L] = y[m]
        d += 1


def simulate_clusters(dinv, dn, dms, support, sweeps, v, plan, seed,
                      halo=None):
    """The cluster kernel's schedule in plain PyTorch (1x1 blocks): the
    clusters in a seeded random order, each on buffers of its own: per
    CTA, D^-1 v and two z buffers of its slice with plan.ghost ghost cells
    on either side, NaN until written. D^-1 v over the window, each CTA
    over its slice and ghosts; sweep s (the CTAs in a random order, in
    lock-step: all read buffer s - 1) on the
    cells of the trapezoid [g R - (S - s) h, (g + 1) R + (S - s) h),
    clipped to the window, with banded.bsgs_sweeps's arithmetic (band k
    skipped outside its support), every read in the CTA's own buffer;
    each CTA writes its cells to buffer s and pushes them into the other
    CTAs' ghosts as the kernel does (_push_ghosts); the last sweep writes
    the owned cells. `halo` replaces the window's sweeps * h."""
    NC = v.shape[0]
    S, h, C, L, R, G = (plan.sweeps, plan.reach, plan.cluster, plan.slice,
                        plan.owned, plan.ghost)
    if halo is not None:
        plan = dataclasses.replace(plan, sweeps=1, reach=halo)
    nan = float("nan")
    out = torch.full((NC,), nan, dtype=v.dtype)
    g_rng = np.random.default_rng(seed)
    for g in g_rng.permutation(plan.clusters).tolist():
        w0, w1 = plan.window(g)
        slices = plan.slices(g)
        own0, own1 = g * R, min(NC, (g + 1) * R)
        bufs = torch.full((3, C, L + 2 * G), nan, dtype=v.dtype)
        for j, (s0, s1) in enumerate(slices):
            c = _cells(max(s0 - G, w0), min(s0 + L + G, w1))
            bufs[0, j, G + c - s0] = tb._block_mv(dinv[0][:, :, c],
                                                  v.T[:, c])[0]
        if S == 0:
            for j, (s0, s1) in enumerate(slices):
                c = _cells(max(s0, own0), min(s1, own1))
                out[c] = bufs[0, j, G + c - s0]
            continue
        for s in range(1, S + 1):
            src = bufs[0 if s == 1 else 1 + (s - 1) % 2]
            dst = bufs[1 + s % 2]
            shrink = (S - s) * h
            for j in g_rng.permutation(C).tolist():
                s0, s1 = slices[j]
                c = _cells(max(s0, w0, own0 - shrink),
                           min(s1, w1, own1 + shrink))
                if not len(c):
                    continue
                acc = bufs[0, j, G + c - s0].clone()
                for k, (d, (lo, hi)) in enumerate(zip(dms, support)):
                    m = (c >= lo) & (c < hi)
                    x = src[j, G + c[m] - s0 + d]
                    acc[m] = acc[m] - tb._block_mv(dn[k][:, :, c[m]],
                                                   x[None])[0]
                if s < S:
                    dst[j, G + c - s0] = acc
                    _push_ghosts(dst, j, c - s0, acc, L, G)
                else:
                    out[c] = acc
    return out[:, None]


def _local_case(name, heat_structures):
    """(NC, shifts, supports) of a simulated 1x1 case: heat 16, or a
    synthetic local structure (shifts of either sign, one zero, a
    duplicate, supports short of the wrap and some narrower)."""
    if name == "heat 16":
        return heat_structures[16]
    NC = 997
    dms = (-37, -5, 0, 3, 41, 3)
    support = ((37, NC), (5, 900), (0, NC), (100, 400), (0, NC - 41),
               (0, NC - 3))
    return NC, dms, support


@pytest.mark.parametrize("sweeps", [0, 1, 2, 6])
@pytest.mark.parametrize("name", ["heat 16", "synthetic"])
def test_cluster_schedule_equals_the_twin(heat_structures, name, sweeps):
    NC, dms, support = _local_case(name, heat_structures)
    dinv, dn, v = _inputs(NC, len(dms), seed=sweeps, support=support, V=1)
    p = bk.bsgs_cluster_plan(NC, dms, support, sweeps, torch.float64,
                             H100_CLUSTER_LIMITS)
    assert p.clusters > 1
    want = bk.bsgs_apply_plain(dinv, dn, dms, sweeps, v)
    for seed in range(2):
        z = simulate_clusters(dinv, dn, dms, support, sweeps, v, p, seed)
        assert torch.equal(z, want), seed


@pytest.mark.parametrize("cluster", [2, 4, 16])
def test_cluster_schedule_other_sizes(heat_structures, cluster):
    """Clusters of 2, 4 and 16 CTAs (slices shorter than a shift: reads
    two and more CTAs away) equal the twin too."""
    NC, dms, support = _local_case("synthetic", heat_structures)
    dinv, dn, v = _inputs(NC, len(dms), seed=5, support=support, V=1)
    p = bk.bsgs_cluster_plan(NC, dms, support, 6, torch.float64,
                             H100_CLUSTER_LIMITS, cluster=cluster)
    assert p.cluster == cluster
    want = bk.bsgs_apply_plain(dinv, dn, dms, 6, v)
    assert torch.equal(simulate_clusters(dinv, dn, dms, support, 6, v, p, 0),
                       want)


@pytest.mark.parametrize("name", ["heat 16", "synthetic"])
def test_cluster_schedule_with_a_short_halo_differs(heat_structures, name):
    """With the window widened by (sweeps - 1) * h in place of sweeps * h,
    the first sweep reads outside the cluster's slices: NaN reaches the
    owned cells next to another cluster's."""
    NC, dms, support = _local_case(name, heat_structures)
    dinv, dn, v = _inputs(NC, len(dms), seed=9, support=support, V=1)
    p = bk.bsgs_cluster_plan(NC, dms, support, 6, torch.float64,
                             H100_CLUSTER_LIMITS)
    want = bk.bsgs_apply_plain(dinv, dn, dms, 6, v)
    assert torch.equal(simulate_clusters(dinv, dn, dms, support, 6, v, p, 0),
                       want)
    z = simulate_clusters(dinv, dn, dms, support, 6, v, p, 0,
                          halo=5 * p.reach)
    assert not torch.equal(z, want)
    assert bool(z.isnan().any())
