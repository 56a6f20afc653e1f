"""The port's explicit pseudo-time solver, TVD-RK physical-time solver and
scalar-diffusion space against the JAX package's, at f64 on the CPU.

  - SteadyForwardEuler: 50 steps of the committed cylinder-explicit.ctrl
    (first order, Roe, CFL 0.8) on cylinder_omesh(24, 10), residuals step
    for step to 1e-10 relative;
  - TVDRKSolver, orders 1-3: the isentropic vortex on a 16x16 periodic box
    to a final time the last step is clipped to: the same step count, the
    final time to 1e-12 and the state to 1e-10 of its largest entry;
  - DiffusionFV: the twins of tests/test_heat.py (implicit L2 error order
    in [1.9, 2.1] on triangles and quads, explicit matching implicit), with
    each error equal to the JAX package's to 1e-8 relative; the banded V = 1
    system on the CPU (the plain twins) against the JAX package's banded
    run, and its refusal where the CUDA kernels would take it;
  - UnsteadyFlowCase: the twin of tests/test_unsteady.py's ctrl case, and
    the CLI on the committed cylinder-explicit.ctrl against the JAX CLI's
    printed summary.
"""

import contextlib
import dataclasses
import io
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import parse_cli_output
from fvens_tpu.cases import cli as jax_cli
from fvens_tpu.cases.casesolvers import build_space as jax_build_space
from fvens_tpu.io_config import parse_control_file as jax_parse
from fvens_tpu.mesh import compile_mesh as jax_compile_mesh
from fvens_tpu.mesh.meshgen import cylinder_omesh
from fvens_tpu.solver.steady import SteadyForwardEuler as JaxFE
from fvens_tpu.solver.steady import ToleranceError as JaxToleranceError
from fvens_tpu.solver.unsteady import TVDRKSolver as JaxTVDRK
from fvens_tpu_torch.cases import cli, model_problems as mp
from fvens_tpu_torch.cases.casesolvers import (UnsteadyFlowCase, build_space,
                                               initial_state)
from fvens_tpu_torch.cases.convertformat import write_gmsh2
from fvens_tpu_torch.io_config import parse_control_file
from fvens_tpu_torch.mesh import compile_mesh
from fvens_tpu_torch.solver.steady import SteadyForwardEuler, ToleranceError
from fvens_tpu_torch.solver.unsteady import TVDRK_COEFFS, TVDRKSolver

from test_heat import solve_one as jax_heat_error
from test_torch_residual import to_jax_config
from test_unsteady import vortex_state as jax_vortex_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTRL_DIR = os.path.join(ROOT, "fvens_tpu_torch", "cases", "ctrl")
EXPLICIT_CTRL = os.path.join(CTRL_DIR, "cylinder-explicit.ctrl")
MESH = (24, 10)
BANDED = dict(banded=True, pc="bsgs", pc_sweeps=6)


class _History:
    def __init__(self):
        self.rows = []

    def log(self, step, relres, absres, lin_iters=0, cfl=0.0, **_):
        self.rows.append((step, absres))


def _cyl_md():
    return cylinder_omesh(*MESH, stretch=1.15 ** (20.0 / MESH[1]))


def test_forward_euler_steps_match_jax():
    cfg = parse_control_file(EXPLICIT_CTRL)
    assert cfg.main.stepping == "explicit" and not cfg.numerics.order2
    md = _cyl_md()
    jcfg = to_jax_config(cfg)
    jm = jax_compile_mesh(md, jcfg.bcs, dtype=jnp.float64)
    js = jax_build_space(jcfg)
    log = _History()
    with pytest.raises(JaxToleranceError):
        JaxFE(js, dataclasses.replace(jcfg.main, maxiter=50)).solve(
            jm, jnp.tile(js.uinf, (jm.NC, 1)), logger=log)
    tm = compile_mesh(md, cfg.bcs, dtype=torch.float64, device="cpu")
    ts = build_space(cfg)
    with pytest.raises(ToleranceError) as e:
        SteadyForwardEuler(ts, dataclasses.replace(cfg.main, maxiter=50)) \
            .solve(tm, initial_state(ts, tm))
    info = e.value.info
    assert info.steps == 50 and not info.converged
    assert [h[0] for h in info.history] == [r[0] for r in log.rows]
    for (step, res), h in zip(log.rows, info.history):
        assert abs(h[2] - res) <= 1e-10 * res, (step, res, h[2])
        assert h[3] == cfg.main.cfl_init


def _jax_vortex(n):
    """The JAX package's vortex box, space and state, as
    tests/test_unsteady.py builds them."""
    from fvens_tpu.config import NumericsConfig, PhysicsConfig
    from fvens_tpu.fv.residual import FlowFV
    from fvens_tpu.physics import GasPhysics
    md, bcs = mp.vortex_box(n)
    cm = jax_compile_mesh(md, to_jax_config(bcs))
    space = FlowFV(phy=GasPhysics(g=1.4, Minf=0.5),
                   pcfg=PhysicsConfig(Minf=0.5, viscous=False),
                   ncfg=NumericsConfig(flux="ROE", gradient="LEASTSQUARES",
                                       reconstruction="LINEAR", order2=True))
    L = mp.VORTEX_L
    rc = np.asarray(cm.rc)
    u0 = np.tile(jax_vortex_state(np.zeros((1, 2)) + L, L / 2, L / 2),
                 (cm.NC, 1))
    u0[: cm.n_cells] = jax_vortex_state(rc[: cm.n_cells], L / 2, L / 2)
    return space, cm, u0


def test_vortex_is_the_jax_tests_vortex():
    xy = np.random.default_rng(2).uniform(0.0, 10.0, (50, 2))
    np.testing.assert_array_equal(mp.vortex_state(xy, 5.0, 4.0),
                                  jax_vortex_state(xy, 5.0, 4.0))
    _, _, u0 = _jax_vortex(8)
    _, mesh, t0 = mp.vortex_case("cpu", 8)
    np.testing.assert_array_equal(t0.numpy(), u0)


@pytest.mark.parametrize("order", sorted(TVDRK_COEFFS))
def test_tvdrk_matches_jax(order):
    """Orders 1-3 to t = 0.37 at CFL 0.8 (the last step clipped): the same
    step count, t and state; mass conserved."""
    js, jm, u0 = _jax_vortex(16)
    ju, jt, jn = JaxTVDRK(js, order=order, cfl=0.8).solve(
        jm, jnp.asarray(u0), 0.37)
    space, tm, tu0 = mp.vortex_case("cpu", 16)
    u, t, n = TVDRKSolver(space, order=order, cfl=0.8).solve(tm, tu0, 0.37)
    assert n == jn and n > 3
    assert abs(t - jt) <= 1e-12 and abs(t - 0.37) <= 1e-12
    want = np.asarray(ju)
    assert np.abs(u.numpy() - want).max() <= 1e-10 * np.abs(want).max()
    e = mp.vortex_errors(tm, tu0, u, t)
    assert abs(e["mass"] - e["mass0"]) <= 1e-12 * e["mass0"]
    assert e["l2_error"] < 0.5 * e["l2_vortex"]


@pytest.mark.parametrize("tri", [True, False])
def test_heat_implicit_convergence_order_matches_jax(tri):
    errs = []
    for n in (8, 16, 32):
        err, info, _ = mp.heat_solve("cpu", n, tri)
        want = jax_heat_error(n, tri)
        assert info.converged and abs(err - want) <= 1e-8 * want, (n, err,
                                                                   want)
        errs.append(err)
    order = math.log2(errs[-2] / errs[-1])
    assert 1.9 <= order <= 2.1, f"diffusion order {order} outside [1.9,2.1]"


def test_heat_explicit_matches_implicit_and_jax():
    """On quads, as the reference's explicit heat tests (explls_quad.octrl)."""
    e_imp = mp.heat_solve("cpu", 8, False)[0]
    e_exp, info, _ = mp.heat_solve("cpu", 8, False, implicit=False)
    assert info.converged
    assert abs(e_imp - e_exp) < 5e-4 * max(e_imp, 1e-10)
    want = jax_heat_error(8, False, implicit=False)
    assert abs(e_exp - want) <= 1e-8 * want


def test_heat_banded_v1_matches_jax_and_refuses_the_kernels(monkeypatch):
    """banded=True, bsgs x6, with 1x1 blocks: the JAX package runs its XLA
    banded operators (its Pallas kernels never run off a TPU); the port's
    plain twins match it on the CPU. Where the port would launch its CUDA
    kernels (4x4 blocks only) the step raises NotImplementedError."""
    from fvens_tpu.config import (BCSpec, LinearSolverConfig,
                                  NonlinearUpdateConfig, PseudoTimeConfig)
    from fvens_tpu.fv.diffusion import DiffusionFV
    from fvens_tpu.mesh.meshgen import unit_square
    from fvens_tpu.solver.steady import SteadyBackwardEuler
    from test_heat import exact, source
    cm = jax_compile_mesh(unit_square(16),
                          [BCSpec(marker=1, type="dirichlet", values=(0.0,))])
    solver = SteadyBackwardEuler(
        DiffusionFV(diffusivity=1.0, source=source),
        PseudoTimeConfig(cfl_init=1e4, cfl_fin=1e4, tol=1e-9, maxiter=300),
        LinearSolverConfig(maxiter=60, restart=60, rtol=1e-4, **BANDED),
        NonlinearUpdateConfig(scheme="full"))
    assert solver._banded(cm) is not None
    ju, jinfo = solver.solve(cm, jnp.zeros((cm.NC, 1)))
    rc, area = np.asarray(cm.rc)[:256], np.asarray(cm.area)[:256]
    want = float(np.sqrt(((np.asarray(ju)[:256, 0] - exact(rc)) ** 2
                          * area).sum()))
    err, info, mesh = mp.heat_solve("cpu", 16, False, **BANDED)
    assert info.steps == jinfo.steps
    assert info.total_lin_iters == jinfo.total_lin_iters
    assert abs(err - want) <= 1e-8 * want
    psolver, mesh = mp.heat_solver("cpu", 16, False, **BANDED)
    monkeypatch.setattr(type(psolver), "_kernel_on", lambda self, x: True)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        psolver.solve(mesh, torch.zeros((mesh.NC, 1), dtype=torch.float64))


UNSTEADY_CTRL = """
io {
\tmesh_file "unused.msh"
}
flow_conditions {
\tflow_type euler
\tadiabatic_index 1.4
\tangle_of_attack 0.0
\tfreestream_Mach_number 0.38
}
bc {
\tbc0 {
\t\ttype slipwall
\t\tmarker 2
\t}
\tbc1 {
\t\ttype farfield
\t\tmarker 4
\t}
}
time {
\tsimulation_type unsteady
\tfinal_time 0.05
\ttime_integrator TVDRK
\ttemporal_order 2
\tphysical_cfl 0.4
}
spatial_discretization {
\tinviscid_flux hllc
\tgradient_method leastsquares
\tlimiter none
}
pseudotime {
\tpseudotime_stepping_type explicit
}
"""


def test_unsteady_ctrl_case(tmp_path):
    """The twin of tests/test_unsteady.py::test_unsteady_ctrl_case: the
    ctrl's TVD-RK settings, integration to final_time exactly (last step
    clipped), a finite state, and the JAX package's steps and state."""
    from fvens_tpu.cases import UnsteadyFlowCase as JaxUnsteady
    ctrl = tmp_path / "unsteady.ctrl"
    ctrl.write_text(UNSTEADY_CTRL)
    cfg = parse_control_file(str(ctrl))
    assert cfg.sim_type == "unsteady"
    assert cfg.time_order == 2 and cfg.phy_cfl == 0.4
    md = cylinder_omesh(24, 8)
    mesh = compile_mesh(md, cfg.bcs, dtype=torch.float64, device="cpu")
    u, t, nsteps = UnsteadyFlowCase(cfg).solve(mesh)
    assert abs(t - 0.05) < 1e-12
    assert nsteps > 1
    assert bool(torch.isfinite(u).all())
    jcfg = jax_parse(str(ctrl))
    ju, jt, jn = JaxUnsteady(jcfg).solve(jax_compile_mesh(md, jcfg.bcs))
    want = np.asarray(ju)
    assert nsteps == jn and abs(t - jt) <= 1e-12
    assert np.abs(u.numpy() - want).max() <= 1e-10 * np.abs(want).max()
    with pytest.raises(ValueError, match="TVDRK"):
        UnsteadyFlowCase(dataclasses.replace(
            cfg, time_integrator="BDF2")).solve(mesh)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_cli_explicit_ctrl_matches_jax_cli(tmp_path):
    """Both CLIs on the committed cylinder-explicit.ctrl at 24x10 (first
    order: no starter), its tolerance of 1e-6 relaxed to 1e-2 to keep the
    test short: the same step count and functionals to 1e-10 (CL, zero by
    symmetry, to 1e-12 absolute)."""
    msh = str(tmp_path / "cyl.msh")
    write_gmsh2(msh, _cyl_md())
    with open(EXPLICIT_CTRL) as f:
        text = f.read()
    assert "tolerance      1e-6" in text
    ctrl = str(tmp_path / "explicit.ctrl")
    with open(ctrl, "w") as f:
        f.write(text.replace("tolerance      1e-6", "tolerance      1e-2"))
    out = {}
    for name, main, dev in (("jax", jax_cli.main, ["--platform", "cpu"]),
                            ("port", cli.main, ["--device", "cpu"])):
        rc, text = _run(main, [ctrl, "--mesh_file", msh, "--log_every",
                               "0"] + dev)
        assert rc == 0, text
        out[name] = parse_cli_output(text)
    j, t = out["jax"], out["port"]
    assert t["main_steps"] == j["main_steps"] > 50
    assert t["main_iters"] == j["main_iters"] == 0
    assert t["starter_iters"] == j["starter_iters"] == []
    for k in ("entropy", "CL", "CDp", "CDsf"):
        assert abs(t[k] - j[k]) <= max(1e-10 * abs(j[k]), 1e-12), k


def test_schemes_record_is_what_chip_smoke_reads():
    """records/jax_schemes_history.json, which chip_smoke.py holds the
    card's runs to, records the committed ctrl files at the meshes and
    horizons chip_smoke.py compares, and is self-consistent; its heat
    errors are the port's, and its vortex state decodes to the shape of
    the 64x64 box."""
    import base64
    import json

    import chip_smoke
    with open(os.path.join(ROOT, chip_smoke.JAX_SCHEMES_RECORD)) as f:
        rec = json.load(f)
    naca = rec["naca"]
    assert naca["case"]["ctrl"] == chip_smoke.NACA_CTRL
    assert naca["case"]["solverc"] == chip_smoke.NACA_SOLVERC
    assert naca["case"]["mesh"] == \
        f"naca0012_omesh{chip_smoke.NACA_CHECK_MESH}"
    assert naca["converged"] == (naca["exit"] == 0)
    st, main = naca["starter"], naca["main"]
    assert len(st["lin_iters"]) == st["steps"]
    assert sum(st["lin_iters"]) == st["krylov_iters"]
    hist = main["history"]
    assert [h["step"] for h in hist] == list(range(1, main["steps"] + 1))
    assert sum(h["lin_iters"] for h in hist) == main["krylov_iters"]
    assert min(h["relres"] for h in hist) == main["min_relres"]
    assert len(hist) >= chip_smoke.NACA_AGREE_STEPS
    ctrl_main = parse_control_file(
        os.path.join(ROOT, chip_smoke.NACA_CTRL)).main
    if naca["converged"]:
        assert main["final_relres"] <= ctrl_main.tol
        assert set(naca["functionals"]) == set(chip_smoke.FUNCTIONALS)
    else:
        assert main["steps"] == ctrl_main.maxiter
    assert chip_smoke.NACA_MAIN_STEPS < ctrl_main.maxiter
    ex = rec["explicit"]
    assert ex["case"]["ctrl"] == chip_smoke.EXPLICIT_CTRL
    assert ex["case"]["mesh"] == \
        f"cylinder_omesh{chip_smoke.EXPLICIT_CHECK_MESH}"
    assert len(ex["first"]["history"]) == chip_smoke.EXPLICIT_AGREE_STEPS
    assert ex["full"]["final_relres"] <= parse_control_file(
        EXPLICIT_CTRL).main.tol
    v = rec["vortex"]
    n = v["case"]["n"]
    state = np.frombuffer(base64.b64decode(v["state_f64_base64"]),
                          dtype="<f8").reshape(v["state_shape"])
    assert state.shape == (mp.vortex_case("cpu", n)[1].NC, 4)
    assert v["t"] == v["case"]["final_time"]
    for h in rec["heat"]["implicit"][:2]:
        err = mp.heat_solve("cpu", h["n"], h["tri"])[0]
        assert abs(err - h["l2_error"]) <= 1e-8 * h["l2_error"]
