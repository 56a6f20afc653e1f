"""The line smoother (solver/lines.py, make_line_smoother) and the
aggregation multigrid (solver/multigrid.py) against the JAX package's, on
the CPU at f64:

  - lines_from_mesh and build_hierarchy, bit for bit, on O-meshes, a
    triangulated square and a triangulated cylinder, and on the cylinder
    case's own O-mesh at 32x16 (its cells are near square: every line is a
    single cell there; the NACA0012 O-mesh forms lines of 32 cells);
  - block_thomas, the line smoother (make_preconditioner(kind="bline")),
    the Galerkin coarse operators and the coarse densification to 1e-12 of
    the largest entry; the V-cycle (make_preconditioner(kind="amg")) to
    1e-11, with the dense LU coarse solve and with the coarse smoother;
  - the gather-sum that replaces jax.ops.segment_sum (deterministic on the
    card) equal to segment_sum on ragged segments, bit for bit;
  - the JAX package's own multigrid checks (tests/test_multigrid.py:
    77-154) on the port: the Galerkin operator equals R A R^T built
    densely, and the V-cycle preconditions GMRES better than its smoother
    alone.

The CUDA-tensor runs are held to these CPU runs in
tests/test_torch_options_gpu.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvens_tpu.solver.lines as jlines
import fvens_tpu.solver.linear as jlinear
import fvens_tpu.solver.multigrid as jmg
from fvens_tpu.config import BCSpec as JaxBCSpec
from fvens_tpu.mesh import compile_mesh as jax_compile_mesh
from fvens_tpu.mesh import meshgen as jgen
from fvens_tpu_torch import interop
from fvens_tpu_torch.config import BCSpec
from fvens_tpu_torch.mesh import compile_mesh, meshgen
from fvens_tpu_torch.solver import lines as tlines
from fvens_tpu_torch.solver import linear
from fvens_tpu_torch.solver import multigrid as tmg

from test_torch_gather import MESHES, _jacobian, _meshes

TOL = 1e-12
STRETCHED = "cylinder_omesh(32, 16, stretch)"


@functools.lru_cache(maxsize=None)
def _stretched():
    """The cylinder case's boundary-layer O-mesh at 32x16 (stretch
    1.15**(20/16)): long wall-normal lines."""
    args = (32, 16)
    kw = dict(stretch=1.15 ** (20.0 / 16))
    bcs = ((2, "slipwall"), (4, "farfield"))
    return (jax_compile_mesh(jgen.cylinder_omesh(*args, **kw),
                             [JaxBCSpec(marker=m, type=t) for m, t in bcs],
                             dtype=jnp.float64),
            compile_mesh(meshgen.cylinder_omesh(*args, **kw),
                         [BCSpec(marker=m, type=t) for m, t in bcs],
                         dtype=torch.float64, device="cpu"))


def _mesh_pair(name):
    return _stretched() if name == STRETCHED else _meshes(name)


def _system(name):
    """(JAX mesh, port mesh, D, N), D and N seeded."""
    jm, tm = _mesh_pair(name)
    return (jm, tm) + _jacobian(jm, seed=4)


NAMES = list(MESHES) + [STRETCHED]


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def _jac(D, N):
    return (jlinear.BlockJacobian(jnp.asarray(D), jnp.asarray(N)),
            interop.jacobian_from_numpy(D, N, device="cpu"))


@pytest.mark.parametrize("name", NAMES)
def test_lines_match_jax(name):
    jm, tm = _mesh_pair(name)
    want = jlines.lines_from_mesh(jm)
    got = tlines.lines_from_mesh(tm)
    assert (got.n_lines, got.Lmax) == (want.n_lines, want.Lmax)
    for field in ("line_cells", "line_mask", "dn_slot", "up_slot",
                  "dn_valid", "up_valid", "line_slot_mask",
                  "cell_line_pos"):
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.shape == w.shape and np.array_equal(g, w), field
    if name == "naca0012_omesh(64, 16)":    # lines of up to max_len 32
        assert got.Lmax == 32 and got.n_lines < tm.n_cells
    if name == STRETCHED:      # near-square cells there: no line forms
        assert got.Lmax == 1 and got.n_lines == tm.n_cells


@pytest.mark.parametrize("L", [1, 5, 32])
def test_block_thomas_matches_jax_and_solves(L):
    g = np.random.default_rng(L)
    NL, V = 7, 4
    a = 0.3 * g.standard_normal((NL, L, V, V))
    b = 4.0 * np.eye(V) + 0.5 * g.standard_normal((NL, L, V, V))
    c = 0.3 * g.standard_normal((NL, L, V, V))
    d = g.standard_normal((NL, L, V))
    want = np.asarray(jlines.block_thomas(*(jnp.asarray(t)
                                            for t in (a, b, c, d))))
    got = tlines.block_thomas(*(torch.from_numpy(t) for t in (a, b, c, d)))
    assert _close(got, want)
    # the dense block-tridiagonal solve of one line
    A = np.zeros((L * V, L * V))
    for i in range(L):
        A[i * V:(i + 1) * V, i * V:(i + 1) * V] = b[0, i]
        if i > 0:
            A[i * V:(i + 1) * V, (i - 1) * V:i * V] = a[0, i]
        if i + 1 < L:
            A[i * V:(i + 1) * V, (i + 1) * V:(i + 2) * V] = c[0, i]
    np.testing.assert_allclose(got[0].numpy().reshape(-1),
                               np.linalg.solve(A, d[0].reshape(-1)),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("name", ["naca0012_omesh(64, 16)",
                                  "cylinder_omesh(24, 10, tri)"])
def test_line_smoother_matches_jax(name, sweeps):
    jm, tm, D, N = _system(name)
    jj, tj = _jac(D, N)
    v = np.random.default_rng(6).standard_normal((jm.NC, 4))
    want = jlinear.make_preconditioner(
        jm, jj, "bline", sweeps, lines=jlines.lines_from_mesh(jm))(
            jnp.asarray(v))
    got = linear.make_preconditioner(
        tm, tj, "bline", sweeps, lines=tlines.lines_from_mesh(tm))(
            torch.from_numpy(v))
    assert _close(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_hierarchy_matches_jax(name):
    jm, tm = _mesh_pair(name)
    want = jmg.build_hierarchy(jm, n_levels=3)
    got = tmg.build_hierarchy(tm, n_levels=3)
    assert len(got.levels) == len(want.levels) > 0
    for w, g in zip(want.levels, got.levels):
        assert (g.NCp, g.S) == (w.NCp, w.S)
        for field in ("agg", "tgt", "c_mask", "c_nbrs", "c_nbr_mask"):
            wa, ga = np.asarray(getattr(w, field)), getattr(g, field).numpy()
            assert ga.shape == wa.shape and np.array_equal(ga, wa), field


def test_gather_sum_is_segment_sum():
    """Ragged segments, dropped ids (the dump segment) and empty segments:
    the same sums as jax.ops.segment_sum, bit for bit (the members are
    added in ascending order, as segment_sum adds on the CPU)."""
    g = np.random.default_rng(9)
    n = 40
    ids = g.integers(0, n + 1, size=300)          # n: the dump segment
    ids[:5] = 3                                   # one wide segment
    x = g.standard_normal((300, 4, 4))
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids),
                                          num_segments=n + 1))[:-1]
    got = tmg.GatherSum.build(ids, n, "cpu")(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["cylinder_omesh(25, 8)",
                                  "unit_square(8, tri)"])
def test_galerkin_matches_jax(name):
    jm, tm, D, N = _system(name)
    jD, jN = jnp.asarray(D), jnp.asarray(N)
    tD, tN = torch.from_numpy(D.copy()), torch.from_numpy(N.copy())
    for wl, gl in zip(jmg.build_hierarchy(jm, n_levels=3).levels,
                      tmg.build_hierarchy(tm, n_levels=3).levels):
        jD, jN = jmg._galerkin(wl, jD, jN)
        tD, tN = tmg._galerkin(gl, tD, tN)
        assert _close(tD, jD) and _close(tN, jN)
    want = jmg._densify(jD, jN, wl.c_nbrs)
    assert _close(tmg._densify(tD, tN, gl.c_nbrs), want)


@pytest.mark.parametrize("coarse", ["dense", "sweeps"])
@pytest.mark.parametrize("opts", [dict(), dict(nu1=1, nu2=3, cycles=2,
                                               coarse_sweeps=4)])
@pytest.mark.parametrize("name", ["cylinder_omesh(24, 10)",
                                  "unit_square(8, tri)"])
def test_vcycle_matches_jax(name, opts, coarse, monkeypatch):
    if coarse == "sweeps":
        monkeypatch.setattr(jmg, "_DENSE_COARSE_MAX", 0)
        monkeypatch.setattr(tmg, "_DENSE_COARSE_MAX", 0)
    jm, tm, D, N = _system(name)
    jj, tj = _jac(D, N)
    v = np.random.default_rng(8).standard_normal((jm.NC, 4))
    want = jlinear.make_preconditioner(
        jm, jj, "amg", mg=jmg.build_hierarchy(jm), mg_opts=opts)(
            jnp.asarray(v))
    got = linear.make_preconditioner(
        tm, tj, "amg", mg=tmg.build_hierarchy(tm), mg_opts=opts)(
            torch.from_numpy(v))
    assert _close(got, want, 1e-11)


def test_bline_and_amg_need_their_structures():
    jm, tm, D, N = _system("cylinder_omesh(24, 10)")
    tj = interop.jacobian_from_numpy(D, N, device="cpu")
    with pytest.raises(ValueError, match="LineStructure"):
        linear.make_preconditioner(tm, tj, "bline")
    with pytest.raises(ValueError, match="MGHierarchy"):
        linear.make_preconditioner(tm, tj, "amg")


def test_galerkin_equals_dense_rart():
    """tests/test_multigrid.py:test_galerkin_equals_dense_rart on the port
    (seeded blocks on cylinder_omesh(24, 10)): the coarse operator from the
    gather-sum equals R A R^T built densely."""
    jm, tm, D, N = _system("cylinder_omesh(24, 10)")
    lv = tmg.build_hierarchy(tm, n_levels=1).levels[0]
    Dc, Nc = tmg._galerkin(lv, torch.from_numpy(D), torch.from_numpy(N))
    n, V = tm.n_cells, 4
    nbrs, msk = tm.cell_nbrs.numpy(), tm.nbr_mask.numpy()
    A = np.zeros((n * V, n * V))
    for c in range(n):
        A[c * V:(c + 1) * V, c * V:(c + 1) * V] = D[c]
        for k in range(4):
            if msk[c, k] > 0 and nbrs[c, k] < n:
                j = nbrs[c, k]
                A[c * V:(c + 1) * V, j * V:(j + 1) * V] += N[c, k]
    agg = lv.agg.numpy()[:n]
    na = int(lv.c_mask.sum())
    R = np.zeros((na * V, n * V))
    for c in range(n):
        R[agg[c] * V:(agg[c] + 1) * V, c * V:(c + 1) * V] = np.eye(V)
    Ac = np.zeros((na * V, na * V))
    c_nbrs, c_msk = lv.c_nbrs.numpy(), lv.c_nbr_mask.numpy()
    for i in range(na):
        Ac[i * V:(i + 1) * V, i * V:(i + 1) * V] = Dc[i].numpy()
        for k in range(lv.S):
            if c_msk[i, k] > 0:
                j = c_nbrs[i, k]
                Ac[i * V:(i + 1) * V, j * V:(j + 1) * V] += Nc[i, k].numpy()
    np.testing.assert_allclose(Ac, R @ A @ R.T, rtol=1e-12, atol=1e-9)


def test_amg_preconditions_gmres():
    """tests/test_multigrid.py:test_amg_preconditions_gmres on the port, on
    that test's own system (first-order Roe on cylinder_omesh(48, 24) at a
    perturbed free stream, CFL 500): GMRES(30) with the V-cycle reaches a
    smaller residual than with its smoother alone (2 bsgs sweeps), and
    below 1e-3."""
    from test_multigrid import BCS, _system, make_space
    jm = jax_compile_mesh(jgen.cylinder_omesh(48, 24), BCS,
                          dtype=jnp.float64)
    tm = compile_mesh(meshgen.cylinder_omesh(48, 24),
                      [BCSpec(marker=2, type="slipwall"),
                       BCSpec(marker=4, type="farfield")],
                      dtype=torch.float64, device="cpu")
    jac, rhs = _system(jm, make_space(), cfl=500.0)
    tj = interop.jacobian_from_numpy(np.asarray(jac.D), np.asarray(jac.N),
                                     device="cpu")
    b = torch.from_numpy(np.array(rhs))
    mv = linear.make_bsr_matvec(tm, tj)
    rr = {}
    for kind, kw in (("amg", dict(mg=tmg.build_hierarchy(tm))),
                     ("bsgs", dict(sweeps=2))):
        pc = linear.make_preconditioner(tm, tj, kind, **kw)
        _, _, rr[kind] = linear.gmres(mv, b, torch.zeros_like(b), pc,
                                      restart=30, maxiter=30, rtol=1e-8)
    assert rr["amg"] < rr["bsgs"] and rr["amg"] < 1e-3
