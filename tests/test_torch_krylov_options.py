"""GCRO-DR recycling (linear.gmres_dr), the matrix-free matvecs, warm
start and the cylinder case's solver presets against the JAX package, on
the CPU at f64:

  - gmres_dr, first call (no recycle space) and second call (recycling the
    first's): x to 1e-10 of its largest entry, equal iterations, and the
    recycled space U equal in span (its orthogonal projector to 1e-5: QR
    and SVD signs differ between LAPACK builds, so U is not compared entry
    by entry, and the harvested span moves by the rounding of G over the
    gap between its k-th and (k+1)-th smallest singular values: 8e-8 to
    5e-7 measured), on a dense system and on a preconditioned cylinder
    Jacobian over several restart cycles;
  - the JAX package's own gmres_dr checks (tests/test_solvers.py:132-190)
    on the port: the dense solve, and recycling cutting the iterations;
  - the matrix-free matvecs of a step, on a unit vector: the exact JVP to
    1e-12 of the largest entry, the reference's finite-difference shell to
    1e-7 (the difference quotient divides the two packages' rounding
    differences in the residual, a few 1e-16 of its largest entry, by the
    perturbation 1e-7: 3.5e-8 of the largest entry measured);
  - the JAX package's matrix-free step count check (tests/test_solvers.py:
    46-68) on the port: assembled, JVP and FD solves take the same steps;
  - a non-finite warm-start guess is dropped on the device;
  - the presets and records/jax_solver_options_history.json, which
    chip_smoke.py holds the card's 160x80 runs to, are the same options.

The CUDA-tensor runs are held to these CPU runs in
tests/test_torch_options_gpu.py.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvens_tpu.solver.linear as jlinear
from fvens_tpu.cases.casesolvers import build_space as jax_build_space
from fvens_tpu.mesh import compile_mesh as jax_compile_mesh
from fvens_tpu.mesh.meshgen import cylinder_omesh as jax_cylinder
from fvens_tpu_torch.cases import bigmesh_case
from fvens_tpu_torch.cases.casesolvers import (SteadyFlowCase, build_space,
                                               initial_state)
from fvens_tpu_torch.config import (LinearSolverConfig, NonlinearUpdateConfig,
                                    PseudoTimeConfig)
from fvens_tpu_torch.solver import linear
from fvens_tpu_torch.solver.steady import SteadyBackwardEuler

from test_torch_ilu import _systems, real_system
from test_torch_residual import to_jax_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "records", "jax_solver_options_history.json")
MESH = (16, 8)


def _projector(U):
    """The orthogonal projector onto the span of U's k rows."""
    Q, _ = np.linalg.qr(np.asarray(U).reshape(U.shape[0], -1).T)
    return Q @ Q.T


def _dense_system(seed=1, n=24, v=4):
    rng = np.random.default_rng(seed)
    A = np.eye(n * v) * 4.0 + 0.3 * rng.standard_normal((n * v, n * v))
    return A, rng.standard_normal((n, v)), rng.standard_normal((n, v))


def _both_dr(jmv, jpc, tmv, tpc, b, U=None, Ut=None, **kw):
    want = jlinear.gmres_dr(jmv, jnp.asarray(b), jnp.zeros(b.shape), jpc,
                            U=U, **kw)
    bt = torch.from_numpy(b.copy())
    got = linear.gmres_dr(tmv, bt, torch.zeros_like(bt), tpc, U=Ut, **kw)
    return want, got


def _check_dr(want, got, tol=1e-10):
    x, it, rel, U = want
    tx, tit, trel, tU = got
    x = np.asarray(x)
    assert np.abs(tx.numpy() - x).max() <= tol * np.abs(x).max()
    assert tit == int(it)
    assert tU.shape == U.shape
    assert np.abs(_projector(tU.numpy()) - _projector(U)).max() <= 1e-5
    assert abs(float(trel) - float(rel)) <= 1e-6 * float(rel) + 1e-14


@pytest.mark.parametrize("k,restart,maxiter", [(6, 60, 60), (4, 12, 24)])
def test_gmres_dr_matches_jax_on_a_dense_system(k, restart, maxiter):
    A, b1, b2 = _dense_system()
    n, v = b1.shape
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    jmv = lambda x: (Aj @ x.reshape(-1)).reshape(n, v)
    tmv = lambda x: (At @ x.reshape(-1)).reshape(n, v)
    ident = lambda z: z
    kw = dict(k=k, restart=restart, maxiter=maxiter, rtol=1e-12)
    want, got = _both_dr(jmv, ident, tmv, ident, b1, **kw)
    _check_dr(want, got)
    # the second call recycles each package's own (equal-span) space
    want2, got2 = _both_dr(jmv, ident, tmv, ident, b2, U=want[3],
                           Ut=got[3], **kw)
    _check_dr(want2, got2)


def test_gmres_dr_matches_jax_on_a_preconditioned_jacobian():
    """bsgs x2 on the first-order cylinder_omesh(24, 10) Jacobian at CFL
    50, FGMRES(8) with k = 4 over up to 2 cycles to 1e-9, twice."""
    jm, tm, D, N = _systems("real")
    jac = jlinear.BlockJacobian(jnp.asarray(D), jnp.asarray(N))
    from fvens_tpu_torch import interop
    tj = interop.jacobian_from_numpy(D, N, device="cpu")
    jmv, tmv = jlinear.make_bsr_matvec(jm, jac), linear.make_bsr_matvec(tm,
                                                                        tj)
    jpc = jlinear.make_preconditioner(jm, jac, "bsgs", 2)
    tpc = linear.make_preconditioner(tm, tj, "bsgs", 2)
    rhs = real_system()[2]
    kw = dict(k=4, restart=8, maxiter=16, rtol=1e-9)
    want, got = _both_dr(jmv, jpc, tmv, tpc, rhs, **kw)
    _check_dr(want, got)
    b2 = rhs * (1.0 + 0.1 * np.random.default_rng(3).standard_normal(
        rhs.shape))
    _check_dr(*_both_dr(jmv, jpc, tmv, tpc, b2, U=want[3], Ut=got[3], **kw))


def test_gmres_dr_against_dense_solve():
    """tests/test_solvers.py:test_gmres_dr_against_dense_solve on the
    port."""
    A, b, b2 = _dense_system()
    n, v = b.shape
    At = torch.from_numpy(A)
    mv = lambda x: (At @ x.reshape(-1)).reshape(n, v)
    ident = lambda z: z
    bt = torch.from_numpy(b)
    x, _, _, U = linear.gmres_dr(mv, bt, torch.zeros_like(bt), ident, k=6,
                                 restart=60, maxiter=60, rtol=1e-12)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(
        A, b.reshape(-1)).reshape(n, v), rtol=1e-8, atol=1e-9)
    assert U.shape == (6, n, v)
    b2t = torch.from_numpy(b2)
    x2, _, _, _ = linear.gmres_dr(mv, b2t, torch.zeros_like(b2t), ident, U=U,
                                  k=6, restart=60, maxiter=60, rtol=1e-12)
    np.testing.assert_allclose(x2.numpy(), np.linalg.solve(
        A, b2.reshape(-1)).reshape(n, v), rtol=1e-7, atol=1e-8)


def test_gmres_dr_recycling_cuts_iterations():
    """tests/test_solvers.py:test_gmres_dr_recycling_cuts_iterations on the
    port: on slowly varying systems with a few isolated small eigenvalues
    the recycled space cuts the Krylov iterations below 3/4 of cold
    GMRES's."""
    rng = np.random.default_rng(2)
    n = 96
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    evals = np.linspace(1.0, 2.0, n)
    evals[:4] = [1e-3, 2e-3, 3e-3, 4e-3]
    ident = lambda z: z
    k, m = 6, 20
    U = None
    cold_total = defl_total = 0
    for s in range(4):
        A = torch.from_numpy(Q @ np.diag(evals * (1.0 + 0.01 * s)) @ Q.T)
        mv = lambda x: A @ x
        b = torch.from_numpy(rng.standard_normal(n))
        _, it_cold, rel_c = linear.gmres(mv, b, torch.zeros_like(b), ident,
                                         restart=m, maxiter=5 * m, rtol=1e-8)
        _, it_dr, rel_d, U = linear.gmres_dr(mv, b, torch.zeros_like(b),
                                             ident, U=U, k=k, restart=m,
                                             maxiter=5 * m, rtol=1e-8)
        assert rel_c < 1e-7 and rel_d < 1e-7
        if s > 0:
            cold_total += it_cold
            defl_total += it_dr
    assert defl_total < 0.75 * cold_total, (defl_total, cold_total)


def test_gmres_dr_refuses_the_distributed_form():
    """The distributed form, refused until the distributed path was
    ported, now runs: with a one-rank allreduce (the identity) gmres_dr
    takes the distributed arithmetic (reduced projections, Cholesky-QR of
    a reduced Gram) and must give the single-device solve's x to 1e-10 of
    its largest entry with equal iterations, and a recycled space of the
    same span (projectors to 1e-5, as the JAX comparisons above) whose
    Gram is I to 1e-6, first call and recycling call alike (the
    distributed form against the JAX package's on ranks:
    tests/test_torch_dist_solve.py)."""
    A, b, _ = _dense_system(seed=3)
    At = torch.from_numpy(A)
    mv = lambda x: (At @ x.reshape(-1)).reshape(x.shape)
    ident = lambda z: z
    bt = torch.from_numpy(b.copy())
    kw = dict(k=4, restart=10, maxiter=30, rtol=1e-9)
    U = Ud = None
    for _ in range(2):
        x, it, _, U = linear.gmres_dr(mv, bt, torch.zeros_like(bt), ident,
                                      U=U, **kw)
        xd, itd, _, Ud = linear.gmres_dr(mv, bt, torch.zeros_like(bt),
                                         ident, U=Ud, allreduce=ident, **kw)
        assert itd == it
        assert np.abs((xd - x).numpy()).max() \
            <= 1e-10 * np.abs(x.numpy()).max()
        flat = Ud.reshape(4, -1).numpy()
        np.testing.assert_allclose(flat @ flat.T, np.eye(4), atol=1e-6)
        np.testing.assert_allclose(_projector(Ud.numpy()),
                                   _projector(U.numpy()), atol=1e-5)


def _cyl_solvers(lin, mixed=False):
    """(port solver, port mesh, JAX space, JAX mesh, JAX config) of the
    cylinder case's main solve at MESH with LinearSolverConfig fields
    `lin`."""
    cfg = bigmesh_case.case_config(**lin)
    cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, mixed_precision=mixed))
    case, cm, _ = bigmesh_case.build_case("cpu", *MESH)
    solver = SteadyFlowCase(cfg)._make_solver(build_space(cfg), cfg.main)
    jcfg = to_jax_config(cfg)
    jm = jax_compile_mesh(jax_cylinder(*MESH, stretch=1.15 ** (20.0 / 8)),
                          jcfg.bcs, dtype=jnp.float64)
    return solver, cm, jax_build_space(jcfg), jm, jcfg


def _jax_matvec(space, jm, u, cfl, fd, eps):
    """The JAX package's matrix-free matvec of SteadyBackwardEuler._step
    (fvens_tpu/solver/steady.py:379-411) at f64."""
    rhs, dt = space.compute_residual(jm, u, True)
    diag = (jm.area / (cfl * dt) * jm.cell_mask)[:, None]
    if fd:
        def mv(x):
            p = eps / jnp.maximum(jnp.sqrt((x * x).sum()), 1e-300)
            rp = space.compute_residual(jm, u + p * x, False)[0]
            return diag * x - (rp - rhs) / p
        return mv

    def mv(x):
        _, tang = jax.jvp(lambda v: space.compute_residual(jm, v, False)[0],
                          (u,), (x,))
        return diag * x - tang
    return mv


@pytest.mark.parametrize("kind,tol", [("jvp", 1e-12), ("fd", 1e-7)])
def test_matrix_free_matvec_matches_jax(kind, tol):
    lin = dict(bigmesh_case.MATRIX_FREE_FD if kind == "fd"
               else bigmesh_case.MATRIX_FREE_JVP)
    solver, cm, jspace, jm, jcfg = _cyl_solvers(lin)
    g = np.random.default_rng(11)
    u0 = initial_state(solver.space, cm).numpy()
    u = u0 * (1.0 + 0.02 * g.standard_normal(u0.shape))
    x = g.standard_normal(u0.shape)
    x /= np.sqrt((x * x).sum())      # a Krylov basis vector's norm
    _, _, ops = solver.step_operators(cm, torch.from_numpy(u), 700.0)
    assert ops.matvec is not None
    got = ops.matvec(torch.from_numpy(x)).numpy()
    want = np.asarray(_jax_matvec(jspace, jm, jnp.asarray(u), 700.0,
                                  kind == "fd", jcfg.linear.fd_eps)(
                                      jnp.asarray(x)))
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    # the assembled matvec is the same operator up to the second order
    # terms the first-order Jacobian drops: not the matrix-free one
    asm = linear.make_bsr_matvec(ops.mesh, ops.jac)(torch.from_numpy(x))
    assert np.abs(asm.numpy() - got).max() > 1e-6 * np.abs(want).max()


def test_matrix_free_mixed_precision_lands_in_the_krylov_dtype():
    """Under mixed precision both matvecs return the f32 Krylov dtype (the
    FD shell differences at f64 and its product is cast where it lands)."""
    for preset in (bigmesh_case.MATRIX_FREE_JVP, bigmesh_case.MATRIX_FREE_FD):
        solver, cm, *_ = _cyl_solvers(dict(preset), mixed=True)
        u = initial_state(solver.space, cm)
        _, lrhs, ops = solver.step_operators(cm, u, 700.0)
        assert lrhs.dtype == torch.float32
        assert ops.matvec(lrhs).dtype == torch.float32


def test_matrixfree_same_step_count():
    """tests/test_solvers.py:test_matrixfree_same_step_count on the port,
    on cylinder_omesh(16, 8) (24x10 there): the assembled, JVP and FD
    first-order solves take the same number of steps."""
    from fvens_tpu_torch.config import BCSpec, NumericsConfig, PhysicsConfig
    from fvens_tpu_torch.fv.residual import FlowFV
    from fvens_tpu_torch.mesh import compile_mesh, meshgen
    from fvens_tpu_torch.physics.gas import GasPhysics
    cm = compile_mesh(meshgen.cylinder_omesh(16, 8),
                      [BCSpec(marker=2, type="slipwall"),
                       BCSpec(marker=4, type="farfield")],
                      dtype=torch.float64, device="cpu")
    pcfg = PhysicsConfig(Minf=0.38, viscous=False)
    space = FlowFV(phy=GasPhysics(g=pcfg.gamma, Minf=pcfg.Minf,
                                  Tinf=pcfg.Tinf, Reinf=pcfg.Reinf,
                                  Pr=pcfg.Pr),
                   pcfg=pcfg, ncfg=NumericsConfig(
                       flux="ROE", gradient="NONE", reconstruction="NONE",
                       order2=False))
    pt = PseudoTimeConfig(cfl_init=50.0, cfl_fin=500.0, tol=1e-6,
                          maxiter=200)
    steps = {}
    for key, mf, fd in (("asm", False, False), ("jvp", True, False),
                        ("fd", True, True)):
        lin = LinearSolverConfig(restart=40, maxiter=40, rtol=1e-3,
                                 pc="bcsgs", pc_sweeps=1, matrix_free=mf,
                                 matrix_free_fd=fd)
        solver = SteadyBackwardEuler(space, pt, lin,
                                     NonlinearUpdateConfig("full"))
        _, info = solver.solve(cm, initial_state(space, cm))
        steps[key] = info.steps
    assert steps["asm"] == steps["jvp"] == steps["fd"], steps


def test_warm_start_drops_a_non_finite_guess():
    solver, cm, *_ = _cyl_solvers(dict(bigmesh_case.BSGS_RECYCLE))
    u = initial_state(solver.space, cm)
    cold = solver._step(cm, u, 700.0, 1e-2, return_carry=True)
    bad = torch.full_like(u, float("nan"))
    warm = solver._step(cm, u, 700.0, 1e-2, du0=bad, return_carry=True)
    assert torch.equal(cold[0], warm[0]) and cold[1:3] == warm[1:3]
    # a finite guess is used: the solve starts from it
    again = solver._step(cm, u, 700.0, 1e-2, du0=cold[3],
                         return_carry=True)
    assert again[2] < cold[2]


def test_presets_are_the_records_options():
    """records/jax_solver_options_history.json records the presets of
    bigmesh_case.OPTIONS on the gather cylinder case, each run
    self-consistent."""
    import chip_smoke
    assert os.path.samefile(os.path.join(ROOT,
                                         chip_smoke.JAX_OPTIONS_RECORD),
                            RECORD)
    with open(RECORD) as f:
        rec = json.load(f)
    assert rec["options"] == bigmesh_case.OPTIONS
    want_cfg = to_jax_config(bigmesh_case.case_config(
        **bigmesh_case.GATHER_BSGS))
    assert rec["case"]["config"] == json.loads(json.dumps(
        dataclasses.asdict(want_cfg)))
    assert {r["option"] for r in rec["runs"]} == set(bigmesh_case.OPTIONS)
    for run in rec["runs"]:
        assert run["mesh"] == "cylinder_omesh(160, 80)"
        for part in ("starter_run", "main"):
            s = run[part]
            hist = s["history"]
            assert s["steps"] == len(hist) == hist[-1][0]
            assert s["krylov_iters"] == sum(h[3] for h in hist)
        assert run["converged"] == (run["main"]["final_res"]
                                    <= bigmesh_case.TOL_ABS)
        if run["main_cap"] is not None and not run["converged"]:
            assert run["main"]["steps"] == run["main_cap"]



def test_fd_shell_under_mixed_precision():
    """The JAX package's finite-difference shell under mixed precision
    returns an f64 product into its f32 GMRES loop, whose while_loop
    refuses the carry (TypeError: ROADMAP queue 3, reference-side). The
    port casts the product to the Krylov dtype where it lands in the basis
    and runs: two finite main steps of the cylinder case on
    cylinder_omesh(8, 4)."""
    from fvens_tpu.solver.steady import SteadyBackwardEuler as JaxBE
    lin = dict(bigmesh_case.MATRIX_FREE_FD, mixed_precision=True)
    cfg = bigmesh_case.case_config(**lin)
    jcfg = to_jax_config(cfg)
    jm = jax_compile_mesh(jax_cylinder(8, 4, stretch=1.15 ** 5), jcfg.bcs,
                          dtype=jnp.float64)
    jspace = jax_build_space(jcfg)
    with pytest.raises(TypeError, match="carry"):
        JaxBE(jspace, jcfg.main, jcfg.linear).solve(
            jm, jnp.tile(jspace.uinf, (jm.NC, 1)).astype(jnp.float64))
    _, cm, u0 = bigmesh_case.build_case("cpu", 8, 4, **lin)
    solver = SteadyFlowCase(cfg)._make_solver(build_space(cfg), cfg.main)
    u, info = solver.solve(cm, u0, max_steps=2)
    assert info.steps == 2 and bool(torch.isfinite(u).all())
