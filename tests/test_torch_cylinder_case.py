"""The large-mesh cylinder case end to end: the port's SteadyFlowCase
(first-order starter, then the second-order main solve) and its entry
points in cases/bigmesh_case.py against the JAX package's, on the inviscid
cylinder of scripts/bench_bigmesh.py (M 0.38, HLLC, weighted least squares,
LINEAR, slip wall + far field; banded bsgs x6, FGMRES(90)) at
cylinder_omesh(32, 16), 512 cells.

At this size gmres would take the classic path; both packages' blocked
path is forced by lowering _BLOCKED_N_THRESHOLD, as it runs by itself at the
640x320 mesh. Tolerances:
  - full f64: the starter and the first 5 main steps with equal Krylov
    iterations and residuals to 1e-9 relative;
  - the case as configured (f32 Jacobian/Krylov): convergence in the JAX
    record's main steps and Krylov iterations, the entropy error to 1e-8;
  - an explicit starter or main phase (forward Euler) on
    cylinder_omesh(16, 8): residuals step for step to 1e-9 and the state
    to 1e-9.
"""

import dataclasses
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvens_tpu.solver.linear as jlinear
from fvens_tpu.cases.casesolvers import SteadyFlowCase as JaxCase
from fvens_tpu.cases.casesolvers import build_space as jax_build_space
from fvens_tpu.solver.steady import ToleranceError as JaxToleranceError
from fvens_tpu_torch.cases import bigmesh_case
from fvens_tpu_torch.cases.casesolvers import SteadyFlowCase
from fvens_tpu_torch.output import FlowSolutionFunctionals
from fvens_tpu_torch.solver import linear
from fvens_tpu_torch.solver.steady import ToleranceError

from test_torch_residual import to_jax_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "records", "jax_bigmesh_history.json")
MESH = (32, 16)


def _bench_bigmesh():
    """scripts/bench_bigmesh.py as a module (scripts/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "bench_bigmesh", os.path.join(ROOT, "scripts", "bench_bigmesh.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record():
    with open(RECORD) as f:
        return json.load(f)


def _plain(obj):
    """A config as the JSON record stores it."""
    return json.loads(json.dumps(dataclasses.asdict(obj)))


@pytest.fixture
def blocked_everywhere(monkeypatch):
    """Both packages take blocked GMRES at every size."""
    monkeypatch.setattr(jlinear, "_BLOCKED_N_THRESHOLD", 0)
    monkeypatch.setattr(linear, "_BLOCKED_N_THRESHOLD", 0)


def test_build_case_is_the_bench_bigmesh_case():
    """bigmesh_case.build_case configures the case field by field as
    scripts/bench_bigmesh.py:build_case(banded=True) with --stop abs, on
    the same mesh and free stream."""
    jcase, jmesh, ju0 = _bench_bigmesh().build_case(
        *MESH, platform="cpu", banded=True, tol=1e-16, tol_abs=1e-10)
    case, cm, u0 = bigmesh_case.build_case("cpu", *MESH)
    assert dataclasses.asdict(to_jax_config(case.cfg)) \
        == dataclasses.asdict(jcase.cfg)
    assert case.cfg.linear.pallas and case.cfg.use_starter
    assert not bigmesh_case.build_case("cpu", 8, 4, pallas=False)[0] \
        .cfg.linear.pallas
    assert (cm.n_cells, cm.NC) == (jmesh.n_cells, jmesh.NC) == (512, 512)
    np.testing.assert_array_equal(cm.area.numpy(), np.asarray(jmesh.area))
    assert u0.dtype == torch.float64
    np.testing.assert_array_equal(u0.numpy(), np.asarray(ju0))
    assert bigmesh_case.BIGMESH == (640, 320)
    assert bigmesh_case.TOL_ABS == case.cfg.main.tol_abs == 1e-10


class _History:
    def __init__(self):
        self.rows = []

    def log(self, step, relres, absres, lin_iters=0, cfl=0.0, **_):
        self.rows.append((step, absres, cfl, lin_iters))


def _f64_config(cfg, main_steps):
    """The case in full f64, the main solve cut to `main_steps` steps."""
    return dataclasses.replace(
        cfg, linear=dataclasses.replace(cfg.linear, mixed_precision=False),
        main=dataclasses.replace(cfg.main, maxiter=main_steps))


def _jax_histories(cfg, main_steps):
    """The JAX package's starter and main histories of SteadyFlowCase.solve
    (execute_starter with a logger), the main solve stopped unconverged."""
    from fvens_tpu.cases.casesolvers import initial_state as jinit
    from fvens_tpu.mesh import compile_mesh
    from fvens_tpu.mesh.meshgen import cylinder_omesh
    jcfg = to_jax_config(cfg)
    mesh = compile_mesh(cylinder_omesh(*MESH, stretch=1.15 ** (20.0 / 16)),
                        jcfg.bcs, dtype=jnp.float64)
    case = JaxCase(jcfg)
    u = jinit(jax_build_space(jcfg), mesh).astype(jnp.float64)
    log1, log2 = _History(), _History()
    try:
        u, _ = case._make_solver(jax_build_space(jcfg, order2=False),
                                 jcfg.init).solve(mesh, u, logger=log1)
    except JaxToleranceError:
        pass
    with pytest.raises(JaxToleranceError):
        case.execute_main(mesh, u, logger=log2)
    assert len(log2.rows) == main_steps
    return log1.rows, log2.rows


def _assert_same(jrows, history, rtol):
    assert [r[0] for r in jrows] == [h[0] for h in history]
    for (step, res, cfl, iters), h in zip(jrows, history):
        assert h[4] == iters, (step, iters, h[4])
        assert abs(h[2] - res) <= rtol * res, (step, res, h[2])
        assert abs(h[3] - cfl) <= 1e-9 * cfl


def test_case_steps_match_jax_f64(blocked_everywhere):
    """Starter -> main in full f64 with blocked GMRES in both packages: the
    starter to its tolerance and the first 5 main steps, step for step."""
    cfg = _f64_config(bigmesh_case.case_config(), 5)
    jstart, jmain = _jax_histories(cfg, 5)
    _, cm, u0 = bigmesh_case.build_case("cpu", *MESH)
    case = SteadyFlowCase(cfg)
    with pytest.raises(ToleranceError) as exc:
        case.solve(cm, u0)
    info = exc.value.info
    assert info.steps == 5 and not info.converged
    assert case.starter_info.converged
    _assert_same(jstart, case.starter_info.history, 1e-9)
    _assert_same(jmain, info.history, 1e-9)


def test_run_solve_converges_like_the_jax_record(blocked_everywhere):
    """The case as configured, through its entry point run_solve (a warm-up
    solve, then the timed one, which reuses the case's solvers): the JAX
    record's starter and main steps and Krylov iterations, its final
    residual to 1e-4 relative and its entropy error to 1e-8."""
    rec = next(r for r in _record()["runs"]
               if r["mesh"] == "cylinder_omesh(32, 16)")
    assert rec["blocked_gmres"] and rec["converged"]
    u, rep = bigmesh_case.run_solve("cpu", mesh=MESH)
    assert rep["blocked"] and rep["converged"] and rep["cells"] == 512
    assert u.dtype == torch.float64 and torch.isfinite(u).all()
    assert (rep["starter_steps"], rep["starter_krylov_iters"]) \
        == (rec["starter"]["steps"], rec["starter"]["krylov_iters"])
    assert (rep["main_steps"], rep["main_krylov_iters"]) \
        == (rec["main"]["steps"], rec["main"]["krylov_iters"])
    # the warm-up solve repeats the timed one on the CPU
    assert rep["krylov_iters_all"] == 2 * (rep["starter_krylov_iters"]
                                           + rep["main_krylov_iters"])
    assert rep["abs_res"] <= bigmesh_case.TOL_ABS
    assert abs(rep["abs_res"] - rec["main"]["final_res"]) \
        <= 1e-4 * rec["main"]["final_res"]
    assert abs(rep["entropy"] - rec["entropy"]) <= 1e-8
    assert rep["wall_s"] > 0


def test_run_output_reports_the_entropy_error(blocked_everywhere):
    """run_output solves and returns the entropy error as the JAX package
    computes it; the starter's tolerance failure is swallowed, and the main
    solve then starts from the state the starter began from."""
    cfg = bigmesh_case.case_config()
    cfg = dataclasses.replace(
        cfg, init=dataclasses.replace(cfg.init, maxiter=2),
        main=dataclasses.replace(cfg.main, tol_abs=0.0, tol=0.5))
    _, cm, u0 = bigmesh_case.build_case("cpu", 16, 8)
    case = SteadyFlowCase(cfg)
    assert torch.equal(case.execute_starter(cm, u0), u0)
    assert case.starter_info.steps == 2 and not case.starter_info.converged
    u, info, fnl = case.run_output(cm, u0)
    assert isinstance(fnl, FlowSolutionFunctionals) and info.converged
    assert fnl.mesh_size == cm.h_param and fnl.CL == fnl.CDp == 0.0
    from fvens_tpu.mesh import compile_mesh
    from fvens_tpu.mesh.meshgen import cylinder_omesh
    from fvens_tpu.output import entropy_error as jax_entropy
    jm = compile_mesh(cylinder_omesh(16, 8, stretch=1.15 ** 2.5),
                      cfg.bcs, dtype=jnp.float64)
    want = jax_entropy(jax_build_space(to_jax_config(cfg)), jm,
                       jnp.asarray(u.numpy()))
    assert abs(fnl.entropy - want) <= 1e-14 * max(want, 1.0)
    assert fnl.entropy > 0.0


@pytest.mark.parametrize("change", [
    # an explicit starter (forward Euler at CFL 0.8 to 1e-1), then the
    # implicit main solve cut to 3 steps
    dict(init=dict(stepping="explicit", cfl_init=0.8, cfl_fin=0.8,
                   maxiter=2000),
         main=dict(tol_abs=0.0, tol=1e-16, maxiter=3)),
    # the implicit starter, then an explicit main solve to 1e-2
    dict(main=dict(stepping="explicit", cfl_init=0.8, cfl_fin=0.8,
                   tol_abs=0.0, tol=1e-2, maxiter=5000)),
    # what a .solverc's -pc_type gamg maps to (refused before it was
    # ported): the starter and 3 main steps under the AMG preconditioner
    dict(linear=dict(pc="amg"), main=dict(maxiter=3)),
])
def test_unported_case_options_refused(change):
    """Explicit pseudo-time phases of SteadyFlowCase (refused before they
    were ported) held to the JAX package's on cylinder_omesh(16, 8) in f64:
    the starter's steps, the main solve's steps and residual to 1e-9 and
    the state to 1e-9 of its largest entry (the explicit main solve takes
    hundreds of steps). The same for pc='amg' (the starter and 3 main
    steps)."""
    cfg = bigmesh_case.case_config()
    for key, value in change.items():
        if isinstance(value, dict):
            value = dataclasses.replace(getattr(cfg, key), **value)
        cfg = dataclasses.replace(cfg, **{key: value})
    _, cm, u0 = bigmesh_case.build_case("cpu", 16, 8)
    cfg = _f64_config(cfg, cfg.main.maxiter)
    case = SteadyFlowCase(cfg)
    if cfg.main.stepping == "explicit":
        u, info = case.solve(cm, u0)
    else:
        with pytest.raises(ToleranceError) as e:
            case.solve(cm, u0)
        u, info = None, e.value.info
    from fvens_tpu.cases.casesolvers import initial_state as jinit
    from fvens_tpu.mesh import compile_mesh
    from fvens_tpu.mesh.meshgen import cylinder_omesh
    jcfg = to_jax_config(cfg)
    jm = compile_mesh(cylinder_omesh(16, 8, stretch=1.15 ** 2.5), jcfg.bcs,
                      dtype=jnp.float64)
    jcase = JaxCase(jcfg)
    log = _History()
    ju0 = jinit(jax_build_space(jcfg), jm)
    if u is None:
        with pytest.raises(JaxToleranceError):
            jcase.solve(jm, ju0, logger=log)
    else:
        ju, jinfo = jcase.solve(jm, ju0, logger=log)
        assert info.steps == jinfo.steps and info.converged
        want = np.asarray(ju)
        assert np.abs(u.numpy() - want).max() <= 1e-9 * np.abs(want).max()
    assert case.starter_info.steps > 1 and case.starter_info.converged
    assert [h[0] for h in info.history] == [r[0] for r in log.rows]
    for (step, res, cfl, iters), h in zip(log.rows, info.history):
        assert h[4] == iters and abs(h[2] - res) <= 1e-9 * res, (step, res)


def test_jax_bigmesh_record_is_the_bigmesh_case():
    """records/jax_bigmesh_history.json, which chip_smoke.py holds the
    card's 160x80 run to, records this case and is self-consistent."""
    import chip_smoke
    assert os.path.samefile(os.path.join(ROOT, chip_smoke.JAX_BIGMESH_RECORD),
                            RECORD)
    rec = _record()
    assert rec["case"]["config"] == _plain(
        to_jax_config(bigmesh_case.case_config()))
    assert rec["case"]["stretch"] == "1.15 ** (20 / nj)"
    assert [(r["mesh"], r["blocked_gmres"]) for r in rec["runs"]] == [
        ("cylinder_omesh(32, 16)", True), ("cylinder_omesh(160, 80)", True),
        ("cylinder_omesh(160, 80)", False)]
    for run in rec["runs"]:
        ni, nj = (int(x) for x in run["mesh"][15:-1].split(","))
        assert run["cells"] == ni * nj and run["n"] == 4 * ni * nj
        assert run["converged"]
        for part in ("starter", "main"):
            s = run[part]
            hist = s["history"]
            assert s["steps"] == len(hist) == hist[-1][0]
            assert s["krylov_iters"] == sum(h[3] for h in hist)
            assert s["first_res"] == hist[0][1]
            assert s["final_res"] == hist[-1][1]
        assert run["main"]["final_res"] <= bigmesh_case.TOL_ABS
    ref = chip_smoke.cylinder_record("cylinder_omesh(160, 80)")
    assert [r["blocked_gmres"] for r in ref] == [True, False]


def test_profile_step_takes_the_cylinder_case(capsys, blocked_everywhere):
    """cases/profile_step.py on the cylinder case at a small size on the
    CPU, blocked: the basis phases (an MGS pass, a row_set append) too."""
    from fvens_tpu_torch.cases import profile_step
    profile_step.profile(torch.device("cpu"), (16, 8), 1, pallas=True,
                         case="cylinder")
    lines = capsys.readouterr().out.splitlines()
    rec = {ln.split(" ", 1)[0]: json.loads(ln.split(" ", 1)[1])
           for ln in lines if ln.startswith(("phases ", "trace "))}
    phases, trace = rec["phases"], rec["trace"]
    assert phases["case"] == "cylinder" and phases["blocked"]
    assert phases["gmres_iters"] > 0 and 1 <= phases["mgs_rows"] <= 90
    assert all(phases[k] > 0 for k in ("residual_ms", "jacobian_ms",
                                       "operators_ms", "gmres_ms",
                                       "mgs_pass_ms", "row_set_ms"))
    # on CPU tensors the wrappers take their twins and launch nothing
    assert trace["kernel_launches"] == trace["row_set_launches"] == 0


@pytest.mark.parametrize("name", [n for n in bigmesh_case.OPTIONS
                                  if n != "mf-jvp"])
def test_profile_step_takes_each_option(name, capsys):
    """cases/profile_step.py's cylinder-gather case with --pc set to each
    preset of bigmesh_case.OPTIONS, at a small size on the CPU: one phases
    and one trace line. (mf-jvp shares mf-fd's plumbing; torch.profiler
    tracing its JVP on the CPU takes 18 s.)"""
    from fvens_tpu_torch.cases import profile_step
    profile_step.profile(torch.device("cpu"), (8, 4), 1, pallas=True,
                         case="cylinder-gather", pc=name)
    rec = {ln.split(" ", 1)[0]: json.loads(ln.split(" ", 1)[1])
           for ln in capsys.readouterr().out.splitlines()
           if ln.startswith(("phases ", "trace "))}
    phases = rec["phases"]
    assert phases["option"] == name and phases["gmres_iters"] > 0
    assert all(phases[k] > 0 for k in ("operators_ms", "pc_ms",
                                       "matvec_ms", "step_ms"))
    assert ("gmres_dr_recycled_iters" in phases) == (name == "bsgs-recycle")
    assert rec["trace"]["kernel_launches"] == 0
