"""The slice end to end: the port's banded implicit steady solve against the
JAX package's, step for step, on the bench physics (laminar NACA0012,
bsgs x6, FGMRES(90), banded) on naca0012_omesh(64, 16).

The pseudo-time starts at CFL 50 (ramping to 500): at the bench's CFL 500
the first steps' Krylov solves stop unconverged at 90 iterations and the
trajectory is chaotic — a rounding-level change at step 2 (6.7e-8 relative,
measured with the port on the CPU) becomes a 94% different residual at
step 3 in mixed precision — so a step-for-step comparison there tests
rounding, not the port. At CFL 50 every Krylov solve converges and the two
packages must agree:
  - full f64: equal lin_iters and residuals to 1e-9 relative over 5 steps;
  - mixed precision (f32 Jacobian/Krylov): lin_iters within +-1 and
    residuals to 1e-4 relative over 3 steps.
The first-order (starter) discretization is not chaotic at CFL 500: it
converges to 1e-10 in 12 steps in both packages, step for step.
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvens_tpu.cases.casesolvers import build_space as jax_build_space
from fvens_tpu.cases.casesolvers import initial_state as jax_initial_state
from fvens_tpu.config import LinearSolverConfig as JaxLin
from fvens_tpu.config import NonlinearUpdateConfig as JaxNl
from fvens_tpu.config import PseudoTimeConfig as JaxPt
from fvens_tpu.solver.steady import SteadyBackwardEuler as JaxBE
from fvens_tpu.solver.steady import ToleranceError as JaxToleranceError
from fvens_tpu_torch.cases.bench_case import bench_config, run_solve
from fvens_tpu_torch.cases.casesolvers import build_space, initial_state
from fvens_tpu_torch.config import (LinearSolverConfig, NonlinearUpdateConfig,
                                    PseudoTimeConfig)
from fvens_tpu_torch.solver.steady import (SteadyBackwardEuler,
                                           ToleranceError, residual_norm)

from test_torch_residual import _case


def _configs(mixed, nsteps, cfl=(50.0, 500.0)):
    lin = dict(restart=90, maxiter=90, rtol=1e-2, pc="bsgs", pc_sweeps=6,
               mixed_precision=mixed, banded=True)
    pt = dict(cfl_init=cfl[0], cfl_fin=cfl[1], tol=1e-16, tol_abs=1e-10,
              maxiter=nsteps)
    return lin, pt


class _History:
    """Collects the JAX solver's per-step log lines."""

    def __init__(self):
        self.rows = []

    def log(self, step, relres, res, lin_iters=None, cfl=None, **_):
        self.rows.append((step, res, cfl, lin_iters))


@functools.lru_cache(maxsize=None)
def _jax_history(mixed, nsteps, order2=True, cfl=(50.0, 500.0)):
    jm, _, _, _, _ = _case()
    js = jax_build_space(bench_config(), order2=order2)
    lin, pt = _configs(mixed, nsteps, cfl)
    log = _History()
    solver = JaxBE(js, JaxPt(**pt), JaxLin(**lin), JaxNl("full"))
    try:
        solver.solve(jm, jax_initial_state(js, jm).astype(jnp.float64),
                     logger=log)
    except JaxToleranceError:
        pass
    return log.rows


def _port_history(mixed, nsteps, order2=True, cfl=(50.0, 500.0)):
    _, tm, _, _, _ = _case()
    ts = build_space(bench_config(), order2=order2)
    lin, pt = _configs(mixed, nsteps, cfl)
    solver = SteadyBackwardEuler(ts, PseudoTimeConfig(**pt),
                                 LinearSolverConfig(**lin),
                                 NonlinearUpdateConfig("full"))
    u, info = solver.solve(tm, initial_state(ts, tm), max_steps=nsteps)
    assert info.steps == nsteps
    assert u.dtype == torch.float64 and torch.isfinite(u).all()
    return info


def _assert_same_history(jrows, info, iters_slack, res_tol):
    """Equal steps and CFLs; iterations within iters_slack; residuals within
    res_tol * max(the step's residual, the first step's)."""
    assert len(jrows) == len(info.history)
    res0 = jrows[0][1]
    for (step, res, cfl, iters), (tstep, _, tres, tcfl, titers) in zip(
            jrows, info.history):
        assert step == tstep
        assert abs(titers - iters) <= iters_slack, (step, iters, titers)
        assert abs(tres - res) <= res_tol * max(res, res0), (step, res, tres)
        assert abs(tcfl - cfl) <= 1e-9 * cfl
    assert info.total_lin_iters == sum(h[4] for h in info.history)


@pytest.mark.parametrize("mixed,nsteps,iters_slack,res_tol", [
    (False, 5, 0, 1e-9),
    (True, 3, 1, 1e-4),
])
def test_steps_match_jax(mixed, nsteps, iters_slack, res_tol):
    jrows = _jax_history(mixed, nsteps)
    info = _port_history(mixed, nsteps)
    assert not info.converged
    _assert_same_history(jrows, info, iters_slack, res_tol)


def test_first_order_solve_converges_like_jax():
    """The first-order (starter) discretization at the bench's CFL 500 ->
    5000 converges to 1e-10 in 12 steps in both packages, with equal
    Krylov iterations per step (f64)."""
    jrows = _jax_history(False, 12, order2=False, cfl=(500.0, 5000.0))
    info = _port_history(False, 12, order2=False, cfl=(500.0, 5000.0))
    assert info.converged and info.finalres <= 1e-10
    assert jrows[-1][1] <= 1e-10
    _assert_same_history(jrows, info, 0, 1e-9)


def test_unconverged_solve_raises():
    _, tm, _, ts, _ = _case()
    lin, pt = _configs(False, 2)
    solver = SteadyBackwardEuler(ts, PseudoTimeConfig(**pt),
                                 LinearSolverConfig(**lin),
                                 NonlinearUpdateConfig("full"))
    with pytest.raises(ToleranceError):
        solver.solve(tm, initial_state(ts, tm))


def test_chip_smoke_reference_is_the_jax_history():
    """chip_smoke.py holds the card's small solves to SMALL_CASES: those
    numbers must be the JAX package's histories of these very solves."""
    import chip_smoke
    assert chip_smoke.SMALL_MESH == (64, 16)
    for case in chip_smoke.SMALL_CASES:
        ref = case["ref"]
        jrows = _jax_history(case["mixed"], len(ref), case["order2"],
                             case["cfl"])
        assert [it for _, it in ref] == [r[3] for r in jrows]
        np.testing.assert_allclose([res for res, _ in ref],
                                   [r[1] for r in jrows], rtol=1e-12)


@pytest.mark.parametrize("order2,mixed", [(True, False), (True, True),
                                          (False, True)])
def test_jax_bench_record_is_the_bench_case(order2, mixed):
    """records/jax_bench_history.json, which chip_smoke.py holds the card's
    bench solves to, records this case and is self-consistent."""
    import chip_smoke
    from fvens_tpu_torch.cases import bench_case
    with open(os.path.join(os.path.dirname(chip_smoke.__file__),
                           chip_smoke.JAX_RECORD)) as f:
        case = json.load(f)["case"]
    assert case["mesh"] == f"naca0012_omesh{bench_case.BENCH_MESH}"
    assert case["tol_abs"] == bench_case.TOL_ABS
    assert case["max_steps"] == bench_case.MAX_STEPS
    rec = chip_smoke.jax_record(order2, mixed)
    hist = rec["history"]
    assert rec["steps"] == len(hist) == hist[-1][0]
    assert rec["krylov_iters"] == sum(h[3] for h in hist)
    assert rec["min_res"] == min(h[1] for h in hist)
    assert rec["final_res"] == hist[-1][1] and rec["first_res"] == hist[0][1]
    assert rec["converged"] == (rec["final_res"] <= bench_case.TOL_ABS)
    assert rec["converged"] == (not order2)


def test_bench_case_runs_on_small_mesh():
    """run_solve (the chip smoke test's main path) on a 512-cell O-mesh on
    the CPU: three steps of the banded mixed-precision solve."""
    solve, cm = run_solve("cpu", mesh=(32, 16))
    u, info = solve(max_steps=3)
    assert cm.n_cells == 512 and u.shape == (cm.NC, 4)
    assert u.dtype == torch.float64 and torch.isfinite(u).all()
    assert info.steps == 3 and all(h[4] > 0 for h in info.history)
    assert info.total_lin_iters == sum(h[4] for h in info.history)


@pytest.mark.parametrize("mixed", [False, True])
def test_step_operators_at_the_krylov_precision(mixed):
    """The operators the step solves with (and the card's kernel checks
    use): f64 residual, Krylov system in f32 when mixed, D^-1 the inverse
    of D, and the step built on them."""
    _, tm, _, ts, _ = _case()
    lin, pt = _configs(mixed, 1)
    solver = SteadyBackwardEuler(ts, PseudoTimeConfig(**pt),
                                 LinearSolverConfig(**lin),
                                 NonlinearUpdateConfig("full"))
    u = initial_state(ts, tm)
    rhs, lrhs, ops = solver.step_operators(tm, u, 50.0)
    kdt = torch.float32 if mixed else torch.float64
    assert rhs.dtype == torch.float64 and lrhs.dtype == kdt
    assert torch.equal(lrhs, rhs.to(kdt))
    K = len(ops.bl.offsets)
    for t in (ops.D, ops.Dinv, ops.Bt, ops.DNbt):
        assert t.dtype == kdt
    assert ops.Bt.shape == ops.DNbt.shape == (K, 4, 4, tm.NC)
    eye = torch.eye(4, dtype=kdt).expand(tm.NC, 4, 4)
    tol = 1e-4 if mixed else 1e-12
    assert float((ops.Dinv @ ops.D - eye).abs().max()) <= tol
    _, res, iters = solver._step(tm, u, 50.0, 1e-2)
    assert iters > 0 and res == float(residual_norm(tm, rhs))


def test_profile_step_runs_on_the_host(capsys):
    """The phase timer and trace of cases/profile_step.py at a small size on
    the CPU: one 'phases' and one 'trace' line."""
    from fvens_tpu_torch.cases import profile_step
    profile_step.profile(torch.device("cpu"), (16, 8), 1, pallas=True)
    lines = capsys.readouterr().out.splitlines()
    rec = {ln.split(" ", 1)[0]: json.loads(ln.split(" ", 1)[1])
           for ln in lines if ln.startswith(("phases ", "trace "))}
    phases, trace = rec["phases"], rec["trace"]
    assert phases["gmres_iters"] > 0 and all(
        phases[k] > 0 for k in ("residual_ms", "jacobian_ms", "operators_ms",
                                "gmres_ms", "step_ms"))
    # on CPU tensors the wrapper takes the plain twin and launches nothing
    assert trace["kernel_launches"] == 0 and trace["traced_wall_ms"] > 0
    assert trace["bsgs_launches"] == 0


OPTION_STEPS = 10
FD_AGREE_STEPS = 4
# the PseudoTimeConfig options of the device-resident step (solver/
# device_stepping.py), once refused
STEPPING_OPTIONS = ("pipeline", "device_steps", "bake_mesh")


def _cylinder_main(change, nsteps, pt=None):
    """(port solver, port mesh, JAX solver, JAX mesh): the main solve of the
    cylinder case (cases/bigmesh_case.py, gather bsgs x6) on
    cylinder_omesh(16, 8) in f64, cut to `nsteps` steps, with the
    LinearSolverConfig fields `change` and the PseudoTimeConfig fields
    `pt`."""
    import dataclasses

    from fvens_tpu.cases.casesolvers import SteadyFlowCase as JaxCase
    from fvens_tpu.mesh import compile_mesh as jax_compile_mesh
    from fvens_tpu.mesh.meshgen import cylinder_omesh
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.cases.casesolvers import SteadyFlowCase

    from test_torch_residual import to_jax_config
    cfg = bigmesh_case.case_config(**dict(bigmesh_case.GATHER_BSGS,
                                          **change))
    cfg = dataclasses.replace(
        cfg, linear=dataclasses.replace(cfg.linear, mixed_precision=False),
        main=dataclasses.replace(cfg.main, maxiter=nsteps, **(pt or {})))
    _, cm, _ = bigmesh_case.build_case("cpu", 16, 8)
    jcfg = to_jax_config(cfg)
    jm = jax_compile_mesh(cylinder_omesh(16, 8, stretch=1.15 ** 2.5),
                          jcfg.bcs, dtype=jnp.float64)
    return (SteadyFlowCase(cfg)._make_solver(build_space(cfg), cfg.main),
            cm, JaxCase(jcfg)._make_solver(jax_build_space(jcfg), jcfg.main),
            jm)


@pytest.mark.parametrize("change", [
    dict(pt=dict(pipeline=True)), dict(pt=dict(device_steps=4)),
    dict(pt=dict(bake_mesh=True)), dict(lin=dict(warm_start=True)),
    # the recycling gate open from the second step on
    dict(lin=dict(deflation_k=8, deflation_start_relres=10.0)),
    dict(lin=dict(matrix_free=True)),
    dict(lin=dict(pc="ilu0")), dict(lin=dict(pc="bline")),
    dict(lin=dict(pc="amg")),
    # what a .solverc's -matrix_free_jacobian maps to
    dict(lin=dict(matrix_free=True, matrix_free_fd=True, fd_eps=1e-7)),
])
def test_unported_solver_options_refused(change):
    """The JAX package's other solver options, once refused, each run
    against the JAX package's same option: pipelined stepping, chunks of
    device_steps = 4 (whose last chunk runs past the step limit, 13 steps,
    as the JAX package's does) and baked steps (solver/device_stepping.py,
    the device-controlled GMRES on the CPU), warm start, GCRO-DR
    recycling, the matrix-free JVP and FD matvecs, ilu0, bline, amg: the
    first OPTION_STEPS steps of the cylinder case's main solve from free stream
    on cylinder_omesh(16, 8) in f64, held to the JAX package's step for
    step, Krylov iterations equal and residuals to 1e-9 relative with a
    floor of 1e-12 of the first (the CLI tests' rule); with the FD matvec
    its first FD_AGREE_STEPS steps, to 1e-4 relative with a floor of 1e-9
    of the first (the difference quotient amplifies the packages' rounding
    differences to about 3e-8 of the matvec, which the quasi-Newton steps
    grow about 3x a step: 2e-6, 1.2e-5 and 2.7e-5 at steps 2-4, 6.9e-4 at
    step 6, measured). The JAX package logs no Krylov iterations for the
    steps of a burst or a chunk; there its single-step loop's stand in."""
    lin, pt = change.get("lin", {}), change.get("pt", {})
    solver, cm, jsolver, jm = _cylinder_main(lin, OPTION_STEPS, pt)
    log = _jax_rows(jsolver, jm)
    u, info = solver.solve(cm, initial_state(solver.space, cm),
                           max_steps=OPTION_STEPS)
    assert bool(torch.isfinite(u).all())
    fd = lin.get("matrix_free_fd", False)
    rtol, floor = (1e-4, 1e-9) if fd else (1e-9, 1e-12)
    agree = FD_AGREE_STEPS if fd else OPTION_STEPS
    # a chunk runs its K steps whatever the step limit (the JAX package's
    # _chunk): 1 + 3 chunks of 4 = 13
    nrows = 13 if pt.get("device_steps") == 4 else OPTION_STEPS
    assert len(log) == len(info.history) == nrows
    if pt.get("pipeline") or pt.get("device_steps"):
        # the JAX package logs no Krylov iterations for the steps of a
        # burst or a chunk: its single-step loop's, which its own tests hold
        # these modes to, stand in for them
        base = _jax_rows(*_cylinder_main({}, OPTION_STEPS)[2:])
        log = [r[:3] + (b[3],) for r, b in zip(log, base)] + log[len(base):]
        agree = len(log)
    first = log[0][1]
    for (step, res, cfl, iters), h in zip(log[:agree], info.history):
        assert h[0] == step, (step, h[0])
        assert iters is None or h[4] == iters, (step, h[4], iters)
        assert abs(h[2] - res) <= rtol * res + floor * first, (step, h[2],
                                                                res)
        # the CFL ramp follows the residual ratio
        assert abs(h[3] - cfl) <= rtol * cfl


def _jax_rows(jsolver, jm):
    """The JAX solver's (step, res, cfl, lin_iters) rows from free stream
    (lin_iters None where it logs none); a solve cut short is no error."""
    log = _History()
    try:
        jsolver.solve(jm, jax_initial_state(jsolver.space, jm).astype(
            jnp.float64), logger=log)
    except JaxToleranceError:
        pass
    return log.rows


def test_positivity_and_nan_guard_reported():
    """A non-finite state poisons the reported residual, which the host
    loop counts as a failed step."""
    _, tm, _, ts, _ = _case()
    lin, pt = _configs(False, 1)
    solver = SteadyBackwardEuler(ts, PseudoTimeConfig(**pt),
                                 LinearSolverConfig(**lin),
                                 NonlinearUpdateConfig("full"))
    u = initial_state(ts, tm)
    u[3, 0] = float("nan")
    _, res, _ = solver._step(tm, u, 50.0, 1e-2)
    assert np.isnan(res)


@pytest.mark.parametrize("resratio", [0.5, 1.0, 2.0, 1e-12, 1e12])
@pytest.mark.parametrize("prevcfl", [50.0, 500.0, 4900.0])
def test_exp_residual_ramp_matches_the_jax_function(resratio, prevcfl):
    """exp_residual_ramp against the JAX package's, exactly (host floats):
    the residual rising (ratio below 1, pdown), level (at 1) and falling
    (above 1, pup), each from below, inside and near the top of [100,
    5000], so that the ratios 1e-12 and 1e12 hit the lower and the upper
    clamp from every start."""
    from fvens_tpu.solver.steady import exp_residual_ramp as jax_ramp
    from fvens_tpu_torch.solver.steady import exp_residual_ramp
    args = (100.0, 5000.0, prevcfl, resratio, 0.3, 0.25)
    got = exp_residual_ramp(*args)
    assert isinstance(got, float)
    assert got == jax_ramp(*args)
    assert 100.0 <= got <= 5000.0
    if resratio == 1e-12:
        assert got == 100.0
    if resratio == 1e12:
        assert got == 5000.0
