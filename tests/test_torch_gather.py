"""The gather path (LinearSolverConfig.banded=False, the JAX package's
default) against the JAX package, on the CPU at f64:

  - make_preconditioner (none, bjacobi, bsgs on slot gathers, bcsgs) and
    make_colored_sgs applied to a seeded vector, to 1e-12 of max|z|, on
    O-meshes and a triangulated square; cylinder_omesh(25, 8) has colors of
    unequal size (padded with NC-1) and n_cells a multiple of 8, so NC-1
    is a real cell that the padded slots rewrite;
  - SteadyBackwardEuler on the gather path with bcsgs x3 and bsgs x6, step
    for step over 5 steps at CFL 50 on the bench physics (equal Krylov
    iterations, residuals to 1e-9);
  - the gather forms of the cylinder case at cylinder_omesh(32, 16) against
    the JAX package's runs in records/jax_gather_history.json: the same
    starter and main steps and Krylov iterations;
  - banded=True with pc="bcsgs", and banded=True on a mesh that is not
    band-coverable, take the gather path;
  - ilu0, bline and amg apply as the JAX package's (in detail in
    test_torch_ilu.py and test_torch_lines_mg.py).
"""

import dataclasses
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvens_tpu.solver.linear as jlinear
from fvens_tpu.cases.casesolvers import build_space as jax_build_space
from fvens_tpu.cases.casesolvers import initial_state as jax_initial_state
from fvens_tpu.config import BCSpec as JaxBCSpec
from fvens_tpu.config import LinearSolverConfig as JaxLin
from fvens_tpu.config import NonlinearUpdateConfig as JaxNl
from fvens_tpu.config import PseudoTimeConfig as JaxPt
from fvens_tpu.mesh import compile_mesh as jax_compile_mesh
from fvens_tpu.mesh import meshgen as jgen
from fvens_tpu.solver.steady import SteadyBackwardEuler as JaxBE
from fvens_tpu.solver.steady import ToleranceError as JaxToleranceError
from fvens_tpu_torch import interop
from fvens_tpu_torch.cases import bigmesh_case
from fvens_tpu_torch.cases.bench_case import bench_config
from fvens_tpu_torch.cases.casesolvers import initial_state
from fvens_tpu_torch.config import (BCSpec, LinearSolverConfig,
                                    NonlinearUpdateConfig, PseudoTimeConfig)
from fvens_tpu_torch.mesh import compile_mesh
from fvens_tpu_torch.mesh import meshgen
from fvens_tpu_torch.solver import linear
from fvens_tpu_torch.solver.steady import (GatherOperators,
                                           SteadyBackwardEuler)

from test_torch_residual import _case, to_jax_config
from test_torch_steady import _History, _assert_same_history

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "records", "jax_gather_history.json")
CYL_BCS = ((2, "slipwall"), (4, "farfield"))
# (generator name, arguments, BCs): O-meshes, a triangulated square, and
# meshes with colors of unequal size
MESHES = {
    "naca0012_omesh(64, 16)": ("naca0012_omesh", (64, 16), None),
    "cylinder_omesh(24, 10)": ("cylinder_omesh", (24, 10), CYL_BCS),
    "unit_square(8, tri)": ("unit_square", (8, True), ((1, "farfield"),)),
    "cylinder_omesh(25, 8)": ("cylinder_omesh", (25, 8), CYL_BCS),
    "cylinder_omesh(24, 10, tri)": ("cylinder_omesh", (24, 10, 1.0, 20.0,
                                                       1.15, True), CYL_BCS),
}


@functools.lru_cache(maxsize=None)
def _meshes(name):
    """(JAX mesh, port mesh) of MESHES[name] at f64."""
    gen, args, bcs = MESHES[name]
    if bcs is None:
        jbcs, tbcs = to_jax_config(bench_config()).bcs, bench_config().bcs
    else:
        jbcs = [JaxBCSpec(marker=m, type=t) for m, t in bcs]
        tbcs = [BCSpec(marker=m, type=t) for m, t in bcs]
    return (jax_compile_mesh(getattr(jgen, gen)(*args), jbcs,
                             dtype=jnp.float64),
            compile_mesh(getattr(meshgen, gen)(*args), tbcs,
                         dtype=torch.float64, device="cpu"))


def _jacobian(jm, seed):
    """A seeded block Jacobian in slot form: diagonally dominant D, and N
    zero on the slots without a real neighbour, as assemble_jacobian makes
    it (the clamped neighbour gathers rely on that)."""
    g = np.random.default_rng(seed)
    NC = jm.NC
    D = 4.0 * np.eye(4) + 0.5 * g.standard_normal((NC, 4, 4))
    N = 0.3 * g.standard_normal((NC, 4, 4, 4))
    N *= np.asarray(jm.nbr_mask)[:, :, None, None]
    return D, N


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("kind,sweeps", [("none", 1), ("bjacobi", 1),
                                         ("bsgs", 6), ("bcsgs", 3),
                                         ("bcsgs", 1)])
def test_preconditioner_matches_jax(name, kind, sweeps):
    jm, tm = _meshes(name)
    D, N = _jacobian(jm, seed=len(name))
    v = np.random.default_rng(1).standard_normal((jm.NC, 4))
    want = np.asarray(jlinear.make_preconditioner(
        jm, jlinear.BlockJacobian(jnp.asarray(D), jnp.asarray(N)), kind,
        sweeps)(jnp.asarray(v)))
    pc = linear.make_preconditioner(
        tm, interop.jacobian_from_numpy(D, N, device="cpu"), kind, sweeps)
    z = pc(torch.from_numpy(v)).numpy()
    assert np.abs(z - want).max() <= 1e-12 * np.abs(want).max()


def test_colored_sgs_rewrites_the_padded_row_as_jax():
    """cylinder_omesh(25, 8): 200 cells (NC = 200), four colors of 96, 96, 4
    and 4 cells, the short ones padded with NC-1 = 199, a real cell of
    another color. make_colored_sgs (called as bcsgs calls it) matches the
    JAX package's, which rewrites that cell in every color's pass."""
    jm, tm = _meshes("cylinder_omesh(25, 8)")
    counts = tm.color_counts.tolist()
    assert tm.n_cells == tm.NC == 200 and len(set(counts)) > 1
    rows = tm.color_rows.numpy()
    home = [c for c in range(tm.n_colors) if 199 in rows[c, :counts[c]]]
    padded = [c for c in range(tm.n_colors) if counts[c] < rows.shape[1]]
    assert len(home) == 1 and set(padded) - set(home)
    D, N = _jacobian(jm, seed=3)
    v = np.random.default_rng(2).standard_normal((jm.NC, 4))
    jac = jlinear.BlockJacobian(jnp.asarray(D), jnp.asarray(N))
    Dinv = jlinear.block_jacobi_inverse(jac.D)
    want = np.asarray(jlinear.make_colored_sgs(jm, jac, Dinv, jac.N, 2)(
        jnp.asarray(v)))
    tj = interop.jacobian_from_numpy(D, N, device="cpu")
    z = linear.make_colored_sgs(tm, tj, linear.block_jacobi_inverse(tj.D),
                                tj.N, 2)(torch.from_numpy(v)).numpy()
    assert np.abs(z - want).max() <= 1e-12 * np.abs(want).max()


def test_unknown_and_unported_preconditioners():
    """An unknown preconditioner raises ValueError. ilu0, bline and amg,
    refused before they were ported, apply as the JAX package's, each
    with its per-mesh structure, on cylinder_omesh(24, 10): to 1e-12 of
    max|z| (amg, whose V-cycle nests three levels and an LU solve, to
    1e-11; tests/test_torch_ilu.py and test_torch_lines_mg.py hold each to
    the JAX package in detail)."""
    import fvens_tpu.solver.ilu as jilu
    import fvens_tpu.solver.lines as jlines
    import fvens_tpu.solver.multigrid as jmg
    from fvens_tpu_torch.solver import ilu, lines, multigrid
    jm, tm = _meshes("cylinder_omesh(24, 10)")
    D, N = _jacobian(jm, 0)
    tj = interop.jacobian_from_numpy(D, N, device="cpu")
    jj = jlinear.BlockJacobian(jnp.asarray(D), jnp.asarray(N))
    v = np.random.default_rng(4).standard_normal((jm.NC, 4))
    for kind, tol, jkw, tkw in (
            ("ilu0", 1e-12, dict(ilu=jilu.ilu_structure(jm)),
             dict(ilu=ilu.ilu_structure(tm))),
            ("bline", 1e-12, dict(lines=jlines.lines_from_mesh(jm)),
             dict(lines=lines.lines_from_mesh(tm))),
            ("amg", 1e-11, dict(mg=jmg.build_hierarchy(jm)),
             dict(mg=multigrid.build_hierarchy(tm)))):
        want = np.asarray(jlinear.make_preconditioner(jm, jj, kind, 2,
                                                      **jkw)(jnp.asarray(v)))
        z = linear.make_preconditioner(tm, tj, kind, 2, **tkw)(
            torch.from_numpy(v)).numpy()
        assert np.abs(z - want).max() <= tol * np.abs(want).max(), kind
    with pytest.raises(ValueError):
        linear.make_preconditioner(tm, tj, "jacobi")


def _lin(pc, sweeps, banded=False):
    return dict(restart=90, maxiter=90, rtol=1e-2, pc=pc, pc_sweeps=sweeps,
                mixed_precision=False, banded=banded)


PT = dict(cfl_init=50.0, cfl_fin=500.0, tol=1e-16, tol_abs=1e-10)


@functools.lru_cache(maxsize=None)
def _jax_history(pc, sweeps, banded, nsteps):
    """The JAX package's per-step history of the bench physics on
    naca0012_omesh(64, 16) at f64 from free stream, CFL 50 -> 500."""
    jm, _, _, _, _ = _case()
    js = jax_build_space(to_jax_config(bench_config()))
    log = _History()
    solver = JaxBE(js, JaxPt(maxiter=nsteps, **PT),
                   JaxLin(**_lin(pc, sweeps, banded)), JaxNl("full"))
    try:
        solver.solve(jm, jax_initial_state(js, jm).astype(jnp.float64),
                     logger=log)
    except JaxToleranceError:
        pass
    return log.rows


def _port_solver(pc, sweeps, banded=False, nsteps=5):
    _, tm, _, ts, _ = _case()
    return SteadyBackwardEuler(ts, PseudoTimeConfig(maxiter=nsteps, **PT),
                               LinearSolverConfig(**_lin(pc, sweeps, banded)),
                               NonlinearUpdateConfig("full")), tm


@pytest.mark.parametrize("pc,sweeps", [("bcsgs", 3), ("bsgs", 6)])
def test_gather_steps_match_jax(pc, sweeps):
    """5 steps at CFL 50 in f64: equal Krylov iterations, residuals to
    1e-9 relative."""
    jrows = _jax_history(pc, sweeps, False, 5)
    solver, tm = _port_solver(pc, sweeps)
    u, info = solver.solve(tm, initial_state(solver.space, tm), max_steps=5)
    assert info.steps == 5 and torch.isfinite(u).all()
    _assert_same_history(jrows, info, 0, 1e-9)


def _shuffled_square():
    """unit_square(8, tri) with its cells numbered at random: neighbours at
    scattered index offsets, so not band-coverable."""
    md = meshgen.unit_square(8, tri=True)
    perm = np.random.default_rng(0).permutation(md.inpoel.shape[0])
    md = dataclasses.replace(md, inpoel=md.inpoel[perm],
                             nnode=md.nnode[perm], nfael=md.nfael[perm],
                             vol_regions=md.vol_regions[perm])
    return compile_mesh(md, [BCSpec(marker=1, type="farfield")],
                        dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("pc,shuffled", [("bcsgs", False),  # gather-only pc
                                         ("bsgs", True)])   # not coverable
def test_banded_config_takes_the_gather_path(pc, shuffled):
    """Where the banded path does not apply, as in the JAX package: the
    step's operators are the gather ones, and two steps equal those of the
    same solver with banded=False."""
    solver, tm = _port_solver(pc, 3, banded=True, nsteps=2)
    if shuffled:
        tm = _shuffled_square()
    assert (solver._banded(tm) is None) == shuffled
    u0 = initial_state(solver.space, tm)     # perturbed: a free stream
    u0 = u0 * (1.0 + 0.01 * torch.from_numpy(   # is steady on the square
        np.random.default_rng(5).standard_normal(tuple(u0.shape))))
    _, _, ops = solver.step_operators(tm, u0, 50.0)
    assert isinstance(ops, GatherOperators)
    gather = dataclasses.replace(solver, lin=dataclasses.replace(
        solver.lin, banded=False))
    h1 = solver.solve(tm, u0, max_steps=2)[1].history
    h2 = gather.solve(tm, u0, max_steps=2)[1].history
    assert h1 == h2


def test_banded_bjacobi_matches_jax():
    """The banded bjacobi preconditioner (the plain D^-1 v contraction of
    the JAX package's steady.py:361-362) beside the banded matvec: 5 steps
    at CFL 50 in f64, step for step."""
    jrows = _jax_history("bjacobi", 1, True, 5)
    solver, tm = _port_solver("bjacobi", 1, banded=True)
    assert solver._banded(tm) is not None
    info = solver.solve(tm, initial_state(solver.space, tm), max_steps=5)[1]
    _assert_same_history(jrows, info, 0, 1e-9)


def _record():
    with open(RECORD) as f:
        return json.load(f)


@pytest.mark.parametrize("lin,blocked", [(bigmesh_case.GATHER_BSGS, True),
                                         (bigmesh_case.GATHER_BCSGS, False)])
def test_cylinder_gather_case_matches_the_jax_record(monkeypatch, lin,
                                                     blocked):
    """The gather forms of the cylinder case through run_solve at
    cylinder_omesh(32, 16): the JAX record's starter and main steps and
    Krylov iterations, its final residual to 1e-2 relative (the last
    steps' f32 Krylov solves sum their slot products in another order than
    XLA, which moves a residual near 1e-10 by about 1e-3 relative) and its
    entropy error to 1e-8; gmres blocked for bsgs (forced, as in the
    record), classic for bcsgs."""
    rec = next(r for r in _record()["runs"]
               if r["mesh"] == "cylinder_omesh(32, 16)"
               and r["pc"] == lin["pc"])
    assert rec["blocked_gmres"] == blocked and rec["converged"]
    if blocked:
        monkeypatch.setattr(linear, "_BLOCKED_N_THRESHOLD", 0)
    u, rep = bigmesh_case.run_solve("cpu", mesh=(32, 16), warmup=False,
                                    **lin)
    assert rep["blocked"] == blocked and rep["converged"]
    assert (rep["banded"], rep["pc"], rep["pc_sweeps"]) == (
        False, lin["pc"], lin["pc_sweeps"])
    assert u.dtype == torch.float64 and torch.isfinite(u).all()
    assert (rep["starter_steps"], rep["starter_krylov_iters"]) \
        == (rec["starter"]["steps"], rec["starter"]["krylov_iters"])
    assert (rep["main_steps"], rep["main_krylov_iters"]) \
        == (rec["main"]["steps"], rec["main"]["krylov_iters"])
    assert rep["krylov_iters_all"] == (rep["starter_krylov_iters"]
                                       + rep["main_krylov_iters"])
    assert abs(rep["abs_res"] - rec["main"]["final_res"]) \
        <= 1e-2 * rec["main"]["final_res"]
    assert abs(rep["entropy"] - rec["entropy"]) <= 1e-8


def test_jax_gather_record_is_the_gather_case():
    """records/jax_gather_history.json, which chip_smoke.py holds the
    card's 160x80 gather runs to, records the gather forms of this case
    and is self-consistent."""
    import chip_smoke
    assert os.path.samefile(os.path.join(ROOT, chip_smoke.JAX_GATHER_RECORD),
                            RECORD)
    rec = _record()
    for lin in (bigmesh_case.GATHER_BSGS, bigmesh_case.GATHER_BCSGS):
        cfg = json.loads(json.dumps(dataclasses.asdict(to_jax_config(
            bigmesh_case.case_config(**lin)))))
        assert rec["case"]["config"][lin["pc"]] == cfg
    assert [(r["mesh"], r["pc"], r["blocked_gmres"]) for r in rec["runs"]] \
        == [("cylinder_omesh(32, 16)", "bsgs", True),
            ("cylinder_omesh(160, 80)", "bsgs", True),
            ("cylinder_omesh(160, 80)", "bsgs", False),
            ("cylinder_omesh(32, 16)", "bcsgs", False),
            ("cylinder_omesh(160, 80)", "bcsgs", False),
            ("cylinder_omesh(160, 80)", "bcsgs", True)]
    for run in rec["runs"]:
        assert run["converged"]
        assert run["pc_sweeps"] == {"bsgs": 6, "bcsgs": 3}[run["pc"]]
        for part in ("starter", "main"):
            s = run[part]
            hist = s["history"]
            assert s["steps"] == len(hist) == hist[-1][0]
            assert s["krylov_iters"] == sum(h[3] for h in hist)
            assert s["first_res"] == hist[0][1]
            assert s["final_res"] == hist[-1][1]
        assert run["main"]["final_res"] <= bigmesh_case.TOL_ABS


def test_chip_smoke_gather_reference_is_the_jax_history():
    """chip_smoke.py holds the card's small gather and banded-bjacobi
    solves to GATHER_SMALL_CASES: those numbers must be the JAX package's
    histories of these very solves."""
    import chip_smoke
    for case in chip_smoke.GATHER_SMALL_CASES:
        assert (case["order2"], case["mixed"], case["cfl"]) == (
            True, False, (PT["cfl_init"], PT["cfl_fin"]))
        lin = case["lin"]
        ref = case["ref"]
        jrows = _jax_history(lin["pc"], lin["pc_sweeps"], lin["banded"],
                             len(ref))
        assert [it for _, it in ref] == [r[3] for r in jrows]
        np.testing.assert_allclose([res for res, _ in ref],
                                   [r[1] for r in jrows], rtol=1e-12)


@pytest.mark.parametrize("pc", ["bsgs", "bcsgs"])
def test_profile_step_takes_the_gather_case(capsys, monkeypatch, pc):
    """cases/profile_step.py --case cylinder-gather at a small size on the
    CPU, blocked: the gather operators' phases and the basis phases."""
    from fvens_tpu_torch.cases import profile_step
    monkeypatch.setattr(linear, "_BLOCKED_N_THRESHOLD", 0)
    profile_step.profile(torch.device("cpu"), (16, 8), 1, pallas=True,
                         case="cylinder-gather", pc=pc)
    lines = capsys.readouterr().out.splitlines()
    rec = {ln.split(" ", 1)[0]: json.loads(ln.split(" ", 1)[1])
           for ln in lines if ln.startswith(("phases ", "trace "))}
    phases, trace = rec["phases"], rec["trace"]
    assert phases["case"] == "cylinder-gather" and phases["blocked"]
    assert phases["pc"] == trace["pc"] == pc and not phases["banded"]
    assert phases["gmres_iters"] > 0
    assert all(phases[k] > 0 for k in ("residual_ms", "jacobian_ms",
                                       "operators_ms", "matvec_ms", "pc_ms",
                                       "gmres_ms", "mgs_pass_ms",
                                       "row_set_ms", "step_ms"))
    assert trace["kernel_launches"] == trace["bsgs_launches"] == 0
