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
    memory given, as many as fit;
  - a schedule simulator in plain PyTorch: the phases run block by block
    in seeded random orders that respect only the plan's waits, on the
    kernel's three buffers. It equals bsgs_apply_plain bit for bit at f64
    (the same products in the same order, slice by slice). With waits cut
    to deps (without the reverse set) a block may overwrite z that a
    neighbour has yet to read, and the simulator sees it.
"""

import numpy as np
import pytest
import torch

from fvens_tpu_torch.cases import bigmesh_case
from fvens_tpu_torch.solver import banded as tb
from fvens_tpu_torch.solver import banded_kernels as bk

# what the plan gives a block on an H100: the SM's 228 KB of shared memory
# less the 1 KB the system keeps and the 32 KB left to L1
H100_SMEM = 233_472 - 1024 - bk.BSGS_L1_BYTES
H100_SMS = 132


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


def _plan(NC, support, dtype, smem=H100_SMEM, n_blocks=H100_SMS):
    dense = bk.bsgs_dense_bands(support, NC)
    return bk.bsgs_launch_plan(NC, sum(dense), dtype, smem, n_blocks)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_shared_tier_is_aligned_and_full(dtype):
    """Every block start and the shared tier a whole number of 16-byte
    runs; as many runs as the shared memory holds after its 16-byte
    header, never past the block's range; no shared memory asked for
    without a shared tier."""
    a = bk.bsgs_align(dtype)
    assert a == (4 if dtype == torch.float32 else 2)
    for NC in (1, 3, 129, 1000, 12_800, 204_800):
        for K in (0, 4, 8):
            per_cell = bk.bsgs_cell_bytes(K, dtype)
            for n_blocks in (1, 132, 1000):
                for smem in (0, 16 + per_cell - 1, 48 * 1024, H100_SMEM):
                    p = bk.bsgs_launch_plan(NC, K, dtype, smem, n_blocks)
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
    NC = v.shape[0]
    g = np.random.default_rng(seed)
    Dt, vt = dinv[0], v.T
    bufs = {n: torch.full((4, NC), float("nan"), dtype=v.dtype)
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


def _inputs(NC, K, seed, support=None):
    g = np.random.default_rng(seed)
    dinv = torch.from_numpy(g.standard_normal((1, 4, 4, NC)) / 4)
    dn = torch.from_numpy(g.standard_normal((K, 4, 4, NC)) * (0.5 / (4 * K)))
    for k, (lo, hi) in enumerate(support or ()):
        dn[k, :, :, :lo] = 0
        dn[k, :, :, hi:] = 0
    return dinv, dn, torch.from_numpy(g.standard_normal((NC, 4)))


def _case(name, omesh_structures):
    """(NC, shifts, support, n_blocks) of a simulated case."""
    if name == "cylinder 160x80":
        NC, dms, support = omesh_structures[(160, 80)]
        return NC, dms, support, H100_SMS
    g = np.random.default_rng(3)
    NC = 997
    dms = tuple(int(d) for d in tb._norm_offsets(
        g.integers(-3 * NC, 3 * NC, 6), NC)) + (0, 130)
    support = ((0, NC),) * 5 + ((10, 40), (0, NC), (500, 997))
    return NC, dms, support, 23


@pytest.mark.parametrize("sweeps", [0, 1, 2, 6])
@pytest.mark.parametrize("name", ["cylinder 160x80", "synthetic"])
def test_schedule_equals_the_twin(omesh_structures, name, sweeps):
    NC, dms, support, n_blocks = _case(name, omesh_structures)
    dinv, dn, v = _inputs(NC, len(dms), seed=sweeps, support=support)
    p = bk.bsgs_launch_plan(NC, 4, torch.float64, H100_SMEM, n_blocks)
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
