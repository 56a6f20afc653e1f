"""The port's I/O modules against the JAX package's.

  - the NumPy copies: parse_control_file and load_solver_options of control
    and options files written here give equal configs in both packages,
    field by field (and the same warnings); apply_ordering gives equal
    meshes; write_vtu and write_gmsh2 write the same text;
  - checkpoints: a file written by either package loads in the other with
    the same keys and values, and a solve resumed from it continues as the
    JAX package's own resume does: on the inviscid cylinder of
    cases/ctrl/cylinder.ctrl on cylinder_omesh(24, 10) in f64 at CFL 50,
    the 3 steps after the checkpoint with equal Krylov iterations and
    residuals to 1e-9 relative;
  - the JSONL logger writes the JAX package's keys;
  - options files with -pc_type gamg (amg) and -matrix_free_jacobian (the
    FD matvec) run the solver and the CLI, held to the JAX package's.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvens_tpu.io_config.checkpoint as jck
import fvens_tpu.io_config.ctrl as jctrl
import fvens_tpu.io_config.logs as jlogs
import fvens_tpu.io_config.solverc as jsolverc
import fvens_tpu.io_config.vtu as jvtu
import fvens_tpu.mesh.ordering as jord
from fvens_tpu.cases.casesolvers import build_space as jax_build_space
from fvens_tpu.cases.casesolvers import initial_state as jax_initial_state
from fvens_tpu.cases.convertformat import write_gmsh2 as jax_write_gmsh2
from fvens_tpu.mesh import compile_mesh as jax_compile_mesh
from fvens_tpu.mesh import meshgen as jgen
from fvens_tpu.solver.steady import SteadyBackwardEuler as JaxBE
from fvens_tpu.solver.steady import ToleranceError as JaxToleranceError
import fvens_tpu_torch.io_config.checkpoint as tck
import fvens_tpu_torch.io_config.ctrl as tctrl
import fvens_tpu_torch.io_config.logs as tlogs
import fvens_tpu_torch.io_config.solverc as tsolverc
import fvens_tpu_torch.io_config.vtu as tvtu
import fvens_tpu_torch.mesh.ordering as tord
from fvens_tpu_torch.cases.casesolvers import build_space, initial_state
from fvens_tpu_torch.cases.convertformat import write_gmsh2
from fvens_tpu_torch.mesh import compile_mesh
from fvens_tpu_torch.mesh import meshgen as tgen
from fvens_tpu_torch.solver.steady import SteadyBackwardEuler

from test_torch_mesh import _equal_dataclass
from test_torch_residual import to_jax_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTRL_DIR = os.path.join(ROOT, "fvens_tpu_torch", "cases", "ctrl")

NACA_CTRL = """\
; laminar flow over the NACA0012 aerofoil
io {
  mesh_file "naca.msh"
}
flow_conditions
{
  flow_type navierstokes
  adiabatic_index 1.4
  angle_of_attack 1.25
  freestream_Mach_number 0.5
  freestream_Reynolds_number 5000.0
  freestream_temperature 290.0
  Prandtl_number 0.72
  use_constant_viscosity false
}
bc
{
  bc0 {
    type adiabaticwall
    marker 2
    boundary_values 0.0
  }
  bc1 {
    type inflowoutflow
    marker 4
  }
  listof_output_wall_boundaries 2
}
spatial_discretization {
  inviscid_flux roe
  gradient_method leastsquares
  limiter venkatakrishnan
  limiter_parameter 20.0   # parsed, never assigned, as in the reference
}
Jacobian_inviscid_flux roe
pseudotime
{
  pseudotime_stepping_type implicit
  nonlinear_update_scheme none
  main {
    cfl_min 500
    cfl_max 5000
    tolerance 1e-6
    max_timesteps 600
  }
  initialization {
    cfl_min 250
    cfl_max 250
    tolerance 1e-1
    max_timesteps 100
  }
}
"""

UNSTEADY_CTRL = """\
io
{
  mesh_file "box.msh"
}
flow_conditions {
  flow_type euler
  freestream_Mach_number 0.8
}
bc {
  bc0 {
    type farfield
    marker 1
  }
}
time
{
  simulation_type unsteady
  final_time 2.5
  time_integrator tvdrk
  temporal_order 2
  physical_cfl 0.7
}
spatial_discretization {
  inviscid_flux hllc
  gradient_method none
}
pseudotime {
  pseudotime_stepping_type explicit
}
"""

CTRLS = {"cylinder": None, "naca0012 laminar": NACA_CTRL,
         "unsteady": UNSTEADY_CTRL}

SOLVERCS = {
    "cylinder": None,
    "gamg": "-ksp_type fgmres\n-ksp_rtol 1e-1\n-pc_type gamg\n"
            "-pc_mg_levels 4\n-mg_levels_ksp_max_it 3\n"
            "-mg_coarse_ksp_max_it 20\n-pc_gamg_agg_nsmooths 1\n",
    "matrix-free": "-ksp_max_it 40\n-matrix_free_jacobian\n"
                   "-matrix_free_difference_step 1e-7\n"
                   "-pc_type bjacobi\n-sub_pc_type sor\n",
    "unknown": "# comment\n-ksp_type bcgs\n-ksp_gmres_restart 25\n"
               "-pc_type asm\n-sub_pc_type lu\n-blasted_thread_chunk 8\n"
               "-some_new_option 3\n-mesh_reorder line\n"
               "-mesh_anisotropy_threshold 5.0\n",
    "blasted sgs": "-pc_type bjacobi\n-sub_pc_type shell\n"
                   "-blasted_pc_type sgs\n-ksp_rtol 0.05 # fixed\n",
}


def _file(tmp_path, name, text, default):
    if text is None:
        return os.path.join(CTRL_DIR, default)
    p = tmp_path / name
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("name", list(CTRLS))
def test_parse_control_file_matches_jax(tmp_path, name):
    path = _file(tmp_path, "case.ctrl", CTRLS[name], "cylinder.ctrl")
    got = tctrl.parse_control_file(path)
    want = jctrl.parse_control_file(path)
    assert dataclasses.asdict(to_jax_config(got)) == dataclasses.asdict(want)
    assert tctrl.parse_control_file(path, mesh_file="m.msh").mesh_file \
        == "m.msh"


def test_parse_control_file_errors_match_jax(tmp_path):
    path = _file(tmp_path, "bad.ctrl",
                 NACA_CTRL.replace("inviscid_flux roe", "inviscid_flux xyz"),
                 None)
    with pytest.raises(ValueError) as je:
        jctrl.parse_control_file(path)
    with pytest.raises(ValueError) as te:
        tctrl.parse_control_file(path)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", list(SOLVERCS))
def test_load_solver_options_matches_jax(tmp_path, name):
    path = _file(tmp_path, "opts.solverc", SOLVERCS[name],
                 "cylinder.solverc")
    tw, jw = [], []
    lin, reorder, aniso = tsolverc.load_solver_options(path, warn=tw.append)
    jlin, jreorder, janiso = jsolverc.load_solver_options(path,
                                                          warn=jw.append)
    assert dataclasses.asdict(to_jax_config(lin)) \
        == dataclasses.asdict(jlin)
    assert (reorder, aniso, tw) == (jreorder, janiso, jw)
    assert tsolverc.parse_solverc(path) == jsolverc.parse_solverc(path)


def test_cylinder_solverc_is_bsgs_x6():
    lin, reorder, aniso = tsolverc.load_solver_options(
        os.path.join(CTRL_DIR, "cylinder.solverc"))
    assert (lin.pc, lin.pc_sweeps, lin.restart, lin.maxiter, lin.rtol,
            lin.rtol_adapt) == ("bsgs", 6, 90, 90, 1e-2, False)
    assert not lin.banded and not lin.mixed_precision
    assert (reorder, aniso) == ("", None)


# the residual rule of a solverc option's history against the JAX
# package's: (relative, floor as a fraction of the first residual); the FD
# matvec amplifies the packages' rounding differences (its history parts
# by 1e-6 to 1e-4 over the first steps, tests/test_torch_steady.py)
SOLVERC_RES_RULE = {"gamg": (1e-9, 1e-12), "matrix-free": (1e-4, 1e-9)}
# the main steps held step for step through the CLI (the FD shell's
# history parts by about 3x a step, so over fewer)
SOLVERC_CLI_STEPS = {"gamg": 10, "matrix-free": 4}


def _same_rows(got, want, name, steps):
    """(step, res, iters) rows: equal steps and Krylov iterations over the
    first `steps`, residuals by SOLVERC_RES_RULE[name]."""
    rtol, floor = SOLVERC_RES_RULE[name]
    assert len(got) >= steps and len(want) >= steps
    first = want[0][1]
    for (step, res, iters), (tstep, tres, titers) in zip(want[:steps],
                                                         got[:steps]):
        assert tstep == step and titers == iters, (step, titers, iters)
        assert abs(tres - res) <= rtol * res + floor * first, (step, tres,
                                                               res)


@pytest.mark.parametrize("name", ["gamg", "matrix-free"])
def test_unported_solverc_options_reach_the_solver(tmp_path, name):
    """gamg (-> amg) and the matrix-free shell (-> the FD matvec) are mapped
    as in the JAX package and run in the solver: the first
    SOLVERC_CLI_STEPS steps of the committed cylinder ctrl's main solve on
    cylinder_omesh(8, 4) from free stream, in f64, held to the JAX
    package's solve of the same options."""
    path = _file(tmp_path, "opts.solverc", SOLVERCS[name], None)
    lin, _, _ = tsolverc.load_solver_options(path)
    jlin, _, _ = jsolverc.load_solver_options(path)
    assert lin.pc == ("amg" if name == "gamg" else "bcsgs")
    assert lin.matrix_free == lin.matrix_free_fd == (name == "matrix-free")
    ctrl = os.path.join(CTRL_DIR, "cylinder.ctrl")
    cfg = tctrl.parse_control_file(ctrl)
    jcfg = jctrl.parse_control_file(ctrl)
    steps = SOLVERC_CLI_STEPS[name]
    main = dataclasses.replace(cfg.main, maxiter=steps)
    jmain = dataclasses.replace(jcfg.main, maxiter=steps)
    tm = compile_mesh(tgen.cylinder_omesh(8, 4), cfg.bcs, device="cpu")
    jm = jax_compile_mesh(jgen.cylinder_omesh(8, 4), jcfg.bcs,
                          dtype=jnp.float64)
    space, jspace = build_space(cfg), jax_build_space(jcfg)
    _, info = SteadyBackwardEuler(space, main, lin).solve(
        tm, initial_state(space, tm), max_steps=steps)
    rows = []

    class Log:
        def log(self, step, relres, res, lin_iters=0, **_):
            rows.append((step, res, lin_iters))
    try:
        JaxBE(jspace, jmain, jlin).solve(
            jm, jax_initial_state(jspace, jm).astype(jnp.float64),
            logger=Log())
    except JaxToleranceError:
        pass
    _same_rows([(h[0], h[2], h[4]) for h in info.history], rows, name,
               steps)


@pytest.mark.parametrize("name", ["gamg", "matrix-free"])
def test_solverc_options_run_through_the_cli_as_jax(tmp_path, name):
    """`python -m fvens_tpu_torch.cases.cli` (its main, in this process) on
    the committed cylinder ctrl, its main tolerance 1e-6, with the gamg or
    the matrix-free solverc on cylinder_omesh(12, 6): it converges, and its
    JSONL history agrees with the JAX CLI's over the first
    SOLVERC_CLI_STEPS main steps (equal Krylov iterations, residuals by
    SOLVERC_RES_RULE)."""
    from fvens_tpu.cases import cli as jax_cli
    from fvens_tpu_torch.cases import cli
    opts = _file(tmp_path, "opts.solverc", SOLVERCS[name], None)
    with open(os.path.join(CTRL_DIR, "cylinder.ctrl")) as f:
        text = f.read()
    assert "tolerance      1e-10" in text
    ctrl = tmp_path / "case.ctrl"
    ctrl.write_text(text.replace("tolerance      1e-10",
                                 "tolerance      1e-6"))
    msh = str(tmp_path / "cyl.msh")
    write_gmsh2(msh, tgen.cylinder_omesh(12, 6, stretch=1.15 ** (20 / 6)))
    rows = {}
    for key, main, dev in (("jax", jax_cli.main, ["--platform", "cpu"]),
                           ("port", cli.main, ["--device", "cpu"])):
        hist = str(tmp_path / f"{key}.jsonl")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main([str(ctrl), "--mesh_file", msh, "-options_file", opts,
                       "--history", hist, "--log_every", "0"] + dev)
        assert rc == 0, buf.getvalue()
        with open(hist) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        rows[key] = [(r["step"], r["absres"], r["lin_iters"]) for r in recs]
        assert recs[-1]["relres"] <= 1e-6
    _same_rows(rows["port"], rows["jax"], name, SOLVERC_CLI_STEPS[name])


@pytest.mark.parametrize("name", ["rcm", "line", "line_rcm"])
def test_apply_ordering_matches_jax(name):
    got = tord.apply_ordering(tgen.naca0012_omesh(64, 16), name,
                              anisotropy_threshold=5.0)
    want = jord.apply_ordering(jgen.naca0012_omesh(64, 16), name,
                               anisotropy_threshold=5.0)
    _equal_dataclass(want, got)
    md = tgen.naca0012_omesh(64, 16)
    assert np.array_equal(tord.rcm_ordering(md), jord.rcm_ordering(md))
    assert np.array_equal(tord.line_ordering(md, 5.0),
                          jord.line_ordering(md, 5.0))


def test_write_vtu_and_gmsh2_match_jax(tmp_path):
    md = tgen.cylinder_omesh(24, 10, tri=True)
    rng = np.random.default_rng(3)
    fields = dict(cell_scalars={"density": rng.random(md.nelem)},
                  cell_vectors={"velocity": rng.random((md.nelem, 2))},
                  point_scalars={"p": rng.random(md.npoin)})
    tvtu.write_vtu(str(tmp_path / "t.vtu"), md, **fields)
    jvtu.write_vtu(str(tmp_path / "j.vtu"), md, **fields)
    assert (tmp_path / "t.vtu").read_text() == (tmp_path / "j.vtu").read_text()
    write_gmsh2(str(tmp_path / "t.msh"), md)
    jax_write_gmsh2(str(tmp_path / "j.msh"), md)
    assert (tmp_path / "t.msh").read_text() == (tmp_path / "j.msh").read_text()


def test_checkpoint_files_interchange(tmp_path):
    """The port writes a tensor state (copied to the host) with the JAX
    package's keys; each package loads the other's file."""
    u = np.random.default_rng(1).standard_normal((16, 4))
    extra = {"rtol": 0.05, "rtol_floor": 0.01, "raise_relres": 0.0,
             "resold": 2.5, "cfl_cap": 1e300}
    tck.save_checkpoint(str(tmp_path / "t.npz"), torch.from_numpy(u),
                        step=7, cfl=120.0, res=1.5, initres=3.0, extra=extra)
    jck.save_checkpoint(str(tmp_path / "j.npz"), jnp.asarray(u), step=7,
                        cfl=120.0, res=1.5, initres=3.0, extra=extra)
    for path in ("t.npz", "j.npz"):
        a = jck.load_checkpoint(str(tmp_path / path))
        b = tck.load_checkpoint(str(tmp_path / path))
        assert sorted(a) == sorted(b) == sorted(
            ["u", "step", "cfl", "res", "initres"]
            + ["x_" + k for k in extra])
        for k in a:
            assert np.array_equal(a[k], b[k]), k
        assert np.array_equal(a["u"], u) and a["step"] == 7


class _Rows:
    def __init__(self):
        self.rows = []

    def log(self, step, relres, absres, lin_iters=0, cfl=0.0, **_):
        self.rows.append((step, absres, lin_iters, cfl))


CK_EVERY = 5       # steps before the checkpoint
RESUMED = 3        # steps compared after it


@pytest.fixture(scope="module")
def resume_case(tmp_path_factory):
    """The cylinder ctrl's main solve (bsgs x6, FGMRES(90) at rtol 1e-2
    from its solverc) on cylinder_omesh(24, 10) in f64 at CFL 50 -> 500:
    the JAX package's checkpoint after CK_EVERY steps, the port's, and the
    JAX package's own RESUMED steps from its checkpoint."""
    tmp = tmp_path_factory.mktemp("resume")
    cfg = tctrl.parse_control_file(os.path.join(CTRL_DIR, "cylinder.ctrl"))
    lin, _, _ = tsolverc.load_solver_options(
        os.path.join(CTRL_DIR, "cylinder.solverc"))
    pt = dataclasses.replace(cfg.main, cfl_init=50.0, cfl_fin=500.0,
                             maxiter=CK_EVERY)
    md = tgen.cylinder_omesh(24, 10, stretch=1.15 ** 2)
    jm = jax_compile_mesh(md, cfg.bcs, dtype=jnp.float64)
    tm = compile_mesh(md, cfg.bcs, dtype=torch.float64, device="cpu")
    js, ts = jax_build_space(to_jax_config(cfg)), build_space(cfg)
    jsolver = JaxBE(js, to_jax_config(pt), to_jax_config(lin),
                    to_jax_config(cfg.nl_update),
                    checkpoint_path=str(tmp / "jax.npz"),
                    checkpoint_every=CK_EVERY)
    with pytest.raises(JaxToleranceError):
        jsolver.solve(jm, jax_initial_state(js, jm).astype(jnp.float64))
    tsolver = SteadyBackwardEuler(ts, pt, lin, cfg.nl_update,
                                  checkpoint_path=str(tmp / "port.npz"),
                                  checkpoint_every=CK_EVERY)
    _, info = tsolver.solve(tm, initial_state(ts, tm), max_steps=CK_EVERY)
    assert info.steps == CK_EVERY and (tmp / "port.npz").exists()

    def jax_resume(path):
        """RESUMED steps of the JAX solver from a copy of `path`."""
        shutil.copy(path, tmp / "jax_resume.npz")
        jsolver.checkpoint_path = str(tmp / "jax_resume.npz")
        jsolver.cfg = to_jax_config(dataclasses.replace(
            pt, maxiter=CK_EVERY + RESUMED))
        rows = _Rows()
        with pytest.raises(JaxToleranceError):
            jsolver.solve(jm, jax_initial_state(js, jm).astype(jnp.float64),
                          logger=rows)
        return rows.rows

    return dict(tmp=tmp, pt=pt, lin=lin, cfg=cfg, tm=tm, ts=ts,
                jax_resume=jax_resume,
                jax_rows=jax_resume(tmp / "jax.npz"), info=info)


def _same_steps(got, want):
    assert [r[0] for r in got] == [r[0] for r in want] == list(
        range(CK_EVERY + 1, CK_EVERY + RESUMED + 1))
    for (s, res, it, cfl), (_, jres, jit, jcfl) in zip(got, want):
        assert it == jit, f"step {s}: {it} vs {jit} Krylov iterations"
        assert abs(res - jres) <= 1e-9 * jres, f"step {s}: {res} vs {jres}"
        assert abs(cfl - jcfl) <= 1e-12 * jcfl


def test_port_resumes_from_jax_checkpoint(resume_case, capsys):
    c = resume_case
    shutil.copy(c["tmp"] / "jax.npz", c["tmp"] / "port_resume.npz")
    solver = SteadyBackwardEuler(
        c["ts"], dataclasses.replace(c["pt"], maxiter=CK_EVERY + RESUMED),
        c["lin"], c["cfg"].nl_update,
        checkpoint_path=str(c["tmp"] / "port_resume.npz"),
        checkpoint_every=CK_EVERY)
    rows = _Rows()
    _, info = solver.solve(c["tm"], initial_state(c["ts"], c["tm"]),
                           logger=rows, max_steps=RESUMED)
    assert f"resumed from {c['tmp'] / 'port_resume.npz'} at step " \
        f"{CK_EVERY}" in capsys.readouterr().out
    assert info.steps == CK_EVERY + RESUMED
    _same_steps(rows.rows, c["jax_rows"])


def test_jax_resumes_from_port_checkpoint(resume_case):
    c = resume_case
    a = jck.load_checkpoint(str(c["tmp"] / "port.npz"))
    b = jck.load_checkpoint(str(c["tmp"] / "jax.npz"))
    assert sorted(a) == sorted(b) and a["step"] == b["step"] == CK_EVERY
    np.testing.assert_allclose(a["u"], b["u"], rtol=1e-9, atol=1e-12)
    _same_steps(c["jax_resume"](c["tmp"] / "port.npz"), c["jax_rows"])


def test_logger_writes_the_jax_schema(tmp_path, capsys):
    for mod, name in ((tlogs, "t.jsonl"), (jlogs, "j.jsonl")):
        log = mod.ConvergenceLogger(path=str(tmp_path / name),
                                    print_every=2, label="main")
        log.log(1, 1.0, 0.5, lin_iters=7, cfl=500.0)
        log.log(2, 0.5, 0.25, lin_iters=6, cfl=600.0, entropy=1e-3, CL=0.1,
                CDp=0.01, CDsf=0.001)
        log.close()
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and out[0] == out[2] and out[1][:-7] == out[3][:-7]
    t = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text().split("\n")
         if x]
    j = [json.loads(x) for x in (tmp_path / "j.jsonl").read_text().split("\n")
         if x]
    assert [list(r) for r in t] == [list(r) for r in j]
    assert list(t[1]) == ["step", "relres", "absres", "lin_iters", "cfl",
                          "wall_s", "entropy", "CL", "CDp", "CDsf"]
    for a, b in zip(t, j):
        assert {k: v for k, v in a.items() if k != "wall_s"} \
            == {k: v for k, v in b.items() if k != "wall_s"}


def test_timed_and_device_trace(tmp_path, capsys):
    x = torch.ones(8)
    with tlogs.timed("sum", sync=x):
        x.sum()
    assert capsys.readouterr().out.startswith("[timed] sum: ")
    with tlogs.device_trace(str(tmp_path / "trace")) as prof:
        (x * 2).sum()
    assert prof is not None and (tmp_path / "trace" / "trace.json").exists()
