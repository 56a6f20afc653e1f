"""The port's partition (fvens_tpu_torch/dist/partition.py) and
partitioned band analysis (solver/banded.py) against the JAX package's, on
the CPU with no ranks:

  - part p of the port's ShardedMeshBundle equals slab p of the JAX
    bundle, every CompiledMesh field and every exchange map, at D = 2, 4
    and 8 on cylinder_omesh(32, 12), and the exact per-round message
    lengths agree with the padded maps;
  - greedy_partition, edge_cut, refine_partition and halo_schedule_stats
    equal the JAX package's, and the schedule delivers every halo cell
    once (tests/test_dist.py's partition checks on the port);
  - banded_structure_parts equals the JAX package's array for array, its
    per-part rest lists are the valid prefixes, and bands plus rest cover
    every valid slot once;
  - the banded operators with a part's rest list (the matvec and the bsgs
    sweeps, plain PyTorch) equal the JAX package's on the same seeded
    blocks to 1e-12 of the largest entry;
  - the dist modules import with jax blocked.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvens_tpu.config import BCSpec as JBCSpec
from fvens_tpu.dist import partition as jpart
from fvens_tpu.mesh.meshgen import cylinder_omesh as jax_cylinder
from fvens_tpu.mesh.topology import build_topology as jax_topology
from fvens_tpu.solver import banded as jbanded
from fvens_tpu_torch.config import BCSpec
from fvens_tpu_torch.dist import partition as tpart
from fvens_tpu_torch.mesh.device_mesh import tensor_fields
from fvens_tpu_torch.mesh.meshgen import cylinder_omesh
from fvens_tpu_torch.mesh.topology import build_topology
from fvens_tpu_torch.solver import banded as tbanded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BCS = [BCSpec(marker=2, type="slipwall"), BCSpec(marker=4, type="farfield")]
JBCS = [JBCSpec(marker=2, type="slipwall"), JBCSpec(marker=4, type="farfield")]
MAPS = ("pp_send", "pp_recv", "send_idx", "halo_slots", "halo_src")


def _bundles(D, mesh=(32, 12)):
    return (jpart.partition_mesh(jax_cylinder(*mesh), JBCS, D),
            tpart.partition_mesh(cylinder_omesh(*mesh), BCS, D))


@pytest.mark.parametrize("D", [2, 4, 8])
def test_parts_equal_the_jax_slabs(D):
    jb, tb = _bundles(D)
    for k in ("n_parts", "n_cells_global", "max_send", "max_halo",
              "cut_faces", "halo_cells", "pp_perms"):
        assert getattr(tb, k) == getattr(jb, k), k
    for k in ("NC", "NF", "n_bfaces", "n_ifaces", "n_colors"):
        assert getattr(tb, k) == getattr(jb.mesh, k), k
    np.testing.assert_array_equal(tb.own_counts, np.asarray(jb.own_counts))
    np.testing.assert_array_equal(tb.own_gid, np.asarray(jb.own_gid))
    for p in range(D):
        mesh, maps = tb.part(p, "cpu")
        assert mesh.n_cells == int(jb.own_counts[p])
        for f in tensor_fields():
            want = np.asarray(getattr(jb.mesh, f))[p]
            got = getattr(mesh, f).numpy()
            assert got.shape == want.shape, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        for k in MAPS:
            np.testing.assert_array_equal(getattr(maps, k).numpy(),
                                          np.asarray(getattr(jb, k))[p],
                                          err_msg=k)
        # the exact message lengths: valid prefixes of the padded maps
        recv = np.asarray(jb.pp_recv)
        for r, perm in enumerate(jb.pp_perms):
            srcs = {s: d for s, d in perm}
            dsts = {d: s for s, d in perm}
            assert maps.send_to[r] == srcs.get(p, -1)
            assert maps.recv_from[r] == dsts.get(p, -1)
            n = int((recv[p, r] < jb.mesh.NC).sum())
            assert maps.recv_len[r] == (n if p in dsts else 0)
            assert (recv[p, r, :n] < jb.mesh.NC).all()
            if p in srcs:
                assert maps.send_len[r] == int(
                    (recv[srcs[p], r] < jb.mesh.NC).sum())


def test_partitioners_and_schedule_stats_equal_the_jax_package():
    md, jmd = cylinder_omesh(24, 10), jax_cylinder(24, 10)
    topo, jtopo = build_topology(md), jax_topology(jmd)
    nfael = np.asarray(topo.nfael)
    for D in (3, 4):
        part = tpart.greedy_partition(topo.esuel, nfael, D)
        np.testing.assert_array_equal(
            part, jpart.greedy_partition(jtopo.esuel, nfael, D))
        assert part.min() >= 0 and part.max() == D - 1
        counts = np.bincount(part)
        assert counts.sum() == md.nelem
        assert counts.max() <= 2 * counts.min() + 8
        ref = tpart.refine_partition(topo.esuel, nfael, part, D)
        np.testing.assert_array_equal(
            ref, jpart.refine_partition(jtopo.esuel, nfael, part, D))
        assert tpart.edge_cut(topo.esuel, nfael, ref) \
            == jpart.edge_cut(jtopo.esuel, nfael, ref) \
            <= tpart.edge_cut(topo.esuel, nfael, part)
    jb, tb = _bundles(4)
    hs = tpart.halo_schedule_stats(tb)
    assert hs == jpart.halo_schedule_stats(jb)
    assert 0 < hs["halo_cells"] <= 2 * hs["cut_faces"]
    assert hs["messages_per_exchange"] >= 4
    assert hs["bytes_per_exchange"] == hs["halo_cells"] * 4 * 4


def test_given_partition_is_kept():
    """partition_mesh(part=...) takes the caller's partition as the JAX
    package's does (the tests feed both packages one array)."""
    D = 3
    part = np.arange(24 * 10) * D // (24 * 10)
    jb = jpart.partition_mesh(jax_cylinder(24, 10), JBCS, D, part=part)
    tb = tpart.partition_mesh(cylinder_omesh(24, 10), BCS, D, part=part)
    np.testing.assert_array_equal(tb.own_gid, np.asarray(jb.own_gid))
    np.testing.assert_array_equal(tb.fields["cell_nbrs"],
                                  np.asarray(jb.mesh.cell_nbrs))


@pytest.mark.parametrize("D", [1, 2, 4])
def test_banded_structure_parts_equal_the_jax_package(D):
    jb, tb = _bundles(D)
    want = jbanded.banded_structure_parts(np.asarray(jb.mesh.cell_nbrs),
                                          np.asarray(jb.mesh.nbr_mask))
    got = tbanded.banded_structure_parts(tb.fields["cell_nbrs"],
                                         tb.fields["nbr_mask"])
    assert got.offsets == want.offsets
    for k in ("slot_sel", "valid", "rest_cell", "rest_slot", "rest_nbr",
              "rest_valid"):
        np.testing.assert_array_equal(getattr(got, k),
                                      np.asarray(getattr(want, k)), err_msg=k)
    mask = tb.fields["nbr_mask"] > 0
    assert int(got.valid.sum()) + int(got.rest_valid.sum()) \
        == int(mask.sum())
    for p in range(D):
        bl = got.part(p, "cpu")
        n = int(got.rest_valid[p].sum())
        assert bl.has_rest == (n > 0)
        np.testing.assert_array_equal(bl.rest_cell.numpy(),
                                      got.rest_cell[p, :n])
        # the layers take every entry once, each row at most once a layer
        ent = torch.cat([e for e, _ in bl.rest_layers]) if n else []
        assert sorted(np.asarray(ent).tolist()) == list(range(n))
        for e, rows in bl.rest_layers:
            assert len(set(rows.tolist())) == rows.numel()
            np.testing.assert_array_equal(rows.numpy(),
                                          got.rest_cell[p, e.numpy()])
    if D == 1:
        assert not got.part(0, "cpu").has_rest     # the O-mesh is covered
    else:
        assert 0 < int(got.rest_valid.sum()) < int(got.valid.sum())


@pytest.mark.parametrize("D", [2, 4])
def test_banded_operators_with_rest_equal_the_jax_package(D):
    """The matvec and 3 bsgs sweeps with each part's rest list on seeded
    diagonal and neighbour blocks, against the JAX package's XLA
    operators: to 1e-12 of the largest entry."""
    jb, tb = _bundles(D)
    jparts = jbanded.banded_structure_parts(np.asarray(jb.mesh.cell_nbrs),
                                            np.asarray(jb.mesh.nbr_mask))
    parts = tbanded.banded_structure_parts(tb.fields["cell_nbrs"],
                                           tb.fields["nbr_mask"])
    rng = np.random.default_rng(11)
    NC = tb.NC
    for p in range(D):
        D_ = np.eye(4) * 4.0 + 0.1 * rng.standard_normal((NC, 4, 4))
        N = 0.2 * rng.standard_normal((NC, 4, 4, 4))
        x = rng.standard_normal((NC, 4))
        jbl = jax.tree_util.tree_map(lambda a: a[p], jparts)
        bl = parts.part(p, "cpu")
        jD, jN = jnp.asarray(D_), jnp.asarray(N)
        Dinv = np.linalg.inv(D_)
        want_mv = jbanded.make_banded_matvec(
            jD, jbanded.banded_blocks(jbl, jN), jbl.offsets, bl=jbl,
            R=jbanded.rest_blocks(jbl, jN))(jnp.asarray(x))
        want_pc = jbanded.make_banded_bsgs(
            jnp.asarray(Dinv), jbanded.banded_dn_blocks(jbl, jnp.asarray(Dinv),
                                                        jN),
            jbl.offsets, 3, bl=jbl,
            DNr=jbanded.rest_dn_blocks(jbl, jnp.asarray(Dinv), jN))(
                jnp.asarray(x))
        tD, tN, tx = (torch.from_numpy(a) for a in (D_, N, x))
        tDinv = torch.from_numpy(Dinv)
        got_mv = tbanded.make_banded_matvec(
            tD, tbanded.banded_blocks(bl, tN), bl.offsets, bl,
            tbanded.rest_blocks(bl, tN))(tx)
        got_pc = tbanded.make_banded_bsgs(
            tDinv, tbanded.banded_dn_blocks(bl, tDinv, tN), bl.offsets, 3,
            bl, tbanded.rest_dn_blocks(bl, tDinv, tN))(tx)
        for got, want in ((got_mv, want_mv), (got_pc, want_pc)):
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() \
                <= 1e-12 * np.abs(want).max()


def test_dist_modules_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import fvens_tpu_torch.dist.partition, fvens_tpu_torch.dist.comm\n"
        "import fvens_tpu_torch.dist.shard, fvens_tpu_torch.dist.launch\n"
        "import fvens_tpu_torch.cases.casesolvers\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and (m.split('.')[0] in ('fvens_tpu', 'jax'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

