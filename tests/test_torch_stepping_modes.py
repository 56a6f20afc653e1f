"""The port's device-resident stepping modes (solver/device_stepping.py) on
the CPU: pipelined stepping, device_steps chunks and baked steps, each the
device-form step (the device-controlled GMRES, eager and masked here)
inside the host loop's recovery logic.

The twins of the JAX package's tests/test_solvers.py:192-257, on
cylinder_omesh(32, 12) at f64 (Roe, second order, FGMRES(40) at rtol 1e-2,
bsgs x4 on slot gathers, CFL 50 -> 2000 to 1e-8), held to the JAX
package's own rules:
  - pipeline against the single-step loop: the same steps and Krylov
    iterations, u to 1e-10, the per-step CFLs to 1e-6, a history row per
    step;
  - device_steps = 8: steps within max(5, 20%), u to 1e-5, a history row
    per step;
  - bake_mesh (the JAX package's baked program is its single step): the
    single step's history, u to 1e-10.
Besides: a blowup injected mid-burst and mid-chunk (the speculative step
in flight is discarded, the recovery history is the single-step loop's),
the controller
on device scalars (TorchXP) against its NumPy evaluation, and the
distributed solver's device_steps refusal and its pipeline and bake_mesh,
which run the device form of its step on gloo ranks on the CPU (held to
its host loop on two ranks) and on NCCL, and its host loop on the
host-staged route.
"""

import numpy as np
import pytest
import torch

from fvens_tpu_torch.config import (BCSpec, LinearSolverConfig,
                                    NonlinearUpdateConfig, NumericsConfig,
                                    PhysicsConfig, PseudoTimeConfig)
from fvens_tpu_torch.fv.residual import FlowFV
from fvens_tpu_torch.mesh.device_mesh import compile_mesh
from fvens_tpu_torch.mesh.meshgen import cylinder_omesh
from fvens_tpu_torch.physics.gas import GasPhysics
from fvens_tpu_torch.solver import steady
from fvens_tpu_torch.solver.device_stepping import TorchXP
from fvens_tpu_torch.solver.steady import (SteadyBackwardEuler,
                                           controller_advance)

BCS = [BCSpec(marker=2, type="slipwall"), BCSpec(marker=4, type="farfield")]
MESH = (32, 12)


def _space():
    pcfg = PhysicsConfig(Minf=0.38, viscous=False)
    ncfg = NumericsConfig(flux="ROE", gradient="LEASTSQUARES",
                          reconstruction="LINEAR", order2=True)
    phy = GasPhysics(g=pcfg.gamma, Minf=pcfg.Minf, Tinf=pcfg.Tinf,
                     Reinf=pcfg.Reinf, Pr=pcfg.Pr)
    return FlowFV(phy=phy, pcfg=pcfg, ncfg=ncfg)


def _solver(cls=SteadyBackwardEuler, **pt):
    lin = LinearSolverConfig(restart=40, maxiter=40, rtol=1e-2, pc="bsgs",
                             pc_sweeps=4)
    cfg = PseudoTimeConfig(cfl_init=50.0, cfl_fin=2000.0, tol=1e-8,
                           maxiter=200, **pt)
    return cls(_space(), cfg, lin, NonlinearUpdateConfig("full"))


_SOLVES = {}


def _solve(**pt):
    """(u, SolveInfo) of the case under the PseudoTimeConfig fields `pt`,
    computed once per set of fields."""
    key = tuple(sorted(pt.items()))
    if key not in _SOLVES:
        cm = compile_mesh(cylinder_omesh(*MESH), BCS, dtype=torch.float64,
                          device="cpu")
        solver = _solver(**pt)
        u0 = solver.space.uinf(torch.float64, "cpu").repeat(cm.NC, 1)
        _SOLVES[key] = solver.solve(cm, u0)
    return _SOLVES[key]


def test_pipelined_stepping_matches_single_step():
    u1, i1 = _solve()
    u2, i2 = _solve(pipeline=True)
    assert i1.converged and i2.converged
    assert i1.steps == i2.steps
    assert i1.total_lin_iters == i2.total_lin_iters
    assert float((u1 - u2).abs().max()) < 1e-10
    assert len(i2.history) == i2.steps
    assert [h[4] for h in i2.history] == [h[4] for h in i1.history]
    np.testing.assert_allclose([h[3] for h in i2.history],
                               [h[3] for h in i1.history], rtol=1e-6)


def test_chunked_device_stepping_matches_single_step():
    u1, i1 = _solve()
    u8, i8 = _solve(device_steps=8)
    assert i1.converged and i8.converged
    assert abs(i1.steps - i8.steps) <= max(5, 0.2 * i1.steps)
    assert float((u1 - u8).abs().max()) < 1e-5
    assert len(i8.history) == i8.steps
    assert sum(h[4] for h in i8.history) == i8.total_lin_iters


def test_baked_steps_match_single_step():
    u1, i1 = _solve()
    ub, ib = _solve(bake_mesh=True)
    assert ib.converged and ib.steps == i1.steps
    assert ib.total_lin_iters == i1.total_lin_iters
    assert float((u1 - ub).abs().max()) < 1e-10
    for a, b in zip(i1.history, ib.history):
        assert a[0] == b[0] and a[4] == b[4]
        assert b[2] == pytest.approx(a[2], rel=1e-9, abs=1e-12 * i1.initres)


class _BlowsUpOnce:
    """A solver whose first step at a CFL above `at` reports a residual
    1e8 times its own (a blowup), in the host step and the device step
    alike; it records the CFL of every step it runs."""
    at = 0.0

    def _fire(self, cfl):
        self.cfls.append(float(cfl))
        if not self.fired and float(cfl) > self.at:
            self.fired = True
            return 1e8
        return 1.0

    def _step(self, mesh, u, cfl, rtol, *a, **k):
        out = super()._step(mesh, u, cfl, rtol, *a, **k)
        return (out[0], out[1] * self._fire(cfl)) + tuple(out[2:])

    def _device_step(self, mesh, u, cfl, rtol, *a, **k):
        out = super()._device_step(mesh, u, cfl, rtol, *a, **k)
        return (out[0], out[1] * self._fire(cfl)) + tuple(out[2:])


class _BlowsUpBE(_BlowsUpOnce, SteadyBackwardEuler):
    pass


@pytest.mark.parametrize("mode", [dict(pipeline=True),
                                  dict(device_steps=8)])
def test_anomaly_mid_burst_recovers_as_the_single_step_loop(mode, capsys):
    """A blowup at the first step above the CFL of step 9 (inside the
    first burst or chunk), in the single-step loop and in the mode; both
    recover from the best state at a tenth of the CFL and the histories
    agree (the residuals to 1e-9, the Krylov iterations and CFLs as the
    rules above). In the pipeline the step after the blowup, already
    queued, is discarded and the history is the single-step loop's row for
    row; a chunk records the blown step, as the JAX package's _chunk does,
    so its history is the single-step loop's with that row inserted."""
    _, i1 = _solve()
    cm = compile_mesh(cylinder_omesh(*MESH), BCS, dtype=torch.float64,
                      device="cpu")
    runs = {}
    for name, pt in (("single", {}), ("mode", mode)):
        s = _solver(_BlowsUpBE, **pt)
        s.at, s.fired, s.cfls = (i1.history[7][3] + i1.history[8][3]) / 2, \
            False, []
        u0 = s.space.uinf(torch.float64, "cpu").repeat(cm.NC, 1)
        u, info = s.solve(cm, u0, max_steps=40)
        runs[name] = (u, info, s)
    out = capsys.readouterr().out
    assert "BE: blowup, retrying from best" in out
    assert "BE: chunk anomaly, retrying from best" in out
    (_, i_s, s_s), (u_m, i_m, s_m) = runs["single"], runs["mode"]
    assert s_s.fired and s_m.fired
    rows_s, rows_m = i_s.history, i_m.history
    if "pipeline" in mode:
        # the step after the blowup was queued before its residual was
        # read: the pipeline ran one step more than it kept
        assert len(s_m.cfls) == len(s_s.cfls) + 1
        assert len(rows_m) == len(rows_s) == 40
    else:
        blown = [k for k, r in enumerate(rows_m)
                 if r[2] > 1e5 * i_m.initres]
        assert len(blown) == 1 and 8 <= blown[0] <= 9
        k = blown[0]
        rows_m = rows_m[:k] + [(r[0] - 1,) + r[1:] for r in rows_m[k + 1:]]
        assert len(rows_m) >= len(rows_s) == 40
    for a, b in zip(rows_s, rows_m):
        assert a[0] == b[0] and a[4] == b[4], a[0]
        assert b[2] == pytest.approx(a[2], rel=1e-9, abs=1e-12 * i_s.initres)
        assert b[3] == pytest.approx(a[3], rel=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_controller_on_device_scalars_matches_numpy(seed):
    """controller_advance through TorchXP (0-dim f64 tensors) against its
    NumPy evaluation, on states that grow, stall and fall, at and above
    the forcing floor: equal up to the ulps of pow."""
    rng = np.random.default_rng(seed)
    solver = _solver()
    cfg, lin = solver.cfg, solver.lin
    for _ in range(50):
        res, resold = 10.0 ** rng.uniform(-9, 1, 2)
        if rng.random() < 0.2:
            res = resold
        state = [10.0 ** rng.uniform(1.5, 3.5), 10.0 ** rng.uniform(2, 4),
                 rng.choice([1e-2, 0.05, 0.2]), rng.choice([1e-2, 0.04]),
                 rng.choice([0.0, 1e-4]), res, resold, 1.0]
        want = controller_advance(cfg, lin, np, *state)
        xp = TorchXP(torch.float64, "cpu")
        got = controller_advance(cfg, lin, xp, *(
            torch.tensor(v, dtype=torch.float64) for v in state))
        for a, b in zip(got, want):
            assert float(a) == pytest.approx(float(b), rel=4e-16, abs=0)


@pytest.fixture(scope="module")
def dist_modes():
    """torch_dist_ranks.mode_histories on two gloo ranks."""
    import torch_dist_ranks as R
    from fvens_tpu_torch.dist import launch
    return launch.run(R.mode_histories, 2, device="cpu", threads=1,
                      timeout=60, join_timeout=300)[0]


@pytest.mark.parametrize("mode", ["device_steps", "pipeline", "bake_mesh"])
def test_distributed_solver_refuses_the_device_modes(mode, request):
    """device_steps > 1 is refused, with the JAX package's wording;
    pipeline and bake_mesh run the device form of the distributed step
    (device_resident on gloo ranks on the CPU): on two gloo ranks the
    first 20 steps of the distributed main solve (banded bsgs x6 on
    cylinder_omesh(32, 12), f64) take the host loop's Krylov iterations
    step for step, its residuals to 1e-9 relative and its state to 1e-9
    of max|u|."""
    from torch_dist_ranks import HISTORY_STEPS

    from fvens_tpu_torch.dist.shard import DistributedBackwardEuler
    if mode == "device_steps":
        with pytest.raises(NotImplementedError, match="device_steps>1"):
            _solver(DistributedBackwardEuler, device_steps=4)
        return
    h = request.getfixturevalue("dist_modes")
    (rows_h, u_h, _), (rows_m, u_m, resident) = h["host"], h[mode]
    assert resident
    assert len(rows_h) == len(rows_m) == HISTORY_STEPS
    for a, b in zip(rows_h, rows_m):
        assert a[0] == b[0] and a[4] == b[4], a[0]
        assert b[2] == pytest.approx(a[2], rel=1e-9, abs=0)
        assert b[3] == pytest.approx(a[3], rel=1e-6)
    assert np.abs(u_m - u_h).max() <= 1e-9 * np.abs(u_h).max()


def test_distributed_solver_is_device_resident_by_route():
    """device_resident wherever no message passes through host memory:
    NCCL and gloo on the CPU; not on gloo ranks sharing a card (host-
    staged), whose solve runs the host loop. Built without a process
    group."""
    import types

    from fvens_tpu_torch.dist.comm import Comm
    from fvens_tpu_torch.dist.shard import DistributedBackwardEuler
    cuda = torch.device("cuda", 0)
    for backend, dev, want in (("nccl", cuda, True), ("gloo", cuda, False),
                               ("gloo", torch.device("cpu"), True)):
        s = _solver(DistributedBackwardEuler, pipeline=True)
        s.flow = types.SimpleNamespace(comm=Comm(0, 2, backend, dev))
        assert s.device_resident is want, (backend, dev)
        assert s.flow.comm.staged is not want


def test_modes_fall_back_to_the_host_loop_where_the_jax_package_does():
    """pipeline with warm start, and device_steps with deflation, run the
    host loop (as the JAX package's solve() does): no program is made."""
    cm = compile_mesh(cylinder_omesh(16, 8), BCS, dtype=torch.float64,
                      device="cpu")
    for pt, lin in ((dict(pipeline=True), dict(warm_start=True)),
                    (dict(device_steps=4), dict(deflation_k=4))):
        s = _solver(**pt)
        s.lin = LinearSolverConfig(**dict(
            restart=40, maxiter=40, rtol=1e-2, pc="bsgs", pc_sweeps=4,
            **lin))
        u0 = s.space.uinf(torch.float64, "cpu").repeat(cm.NC, 1)
        s.solve(cm, u0, max_steps=6)
        assert not s.__dict__.get("_programs")
    assert steady.ChunkProgram and steady.StepProgram


def test_pipelined_step_script_needs_the_card():
    """cases/pipelined_step.py, which times the pipelined 640x320 cylinder
    of a checkout on the card, exits 1 where torch sees none."""
    import os
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script would run on it")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "fvens_tpu_torch", "cases",
                                      "pipelined_step.py"), "--tree", root],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr
