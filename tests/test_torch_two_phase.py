"""Precision scheduling (fvens_tpu_torch/cases/precision.py) against the
JAX package's, on the CPU.

  - live, both packages on the banded cylinder at LIVE_MESH with the gate
    1e-3: the port's case_two_phase (cases/bigmesh_case.py's case) against
    scripts/bench_bigmesh.py:_two_phase_solve, each stopped after phase
    B's first step: phase A's starter in the same steps with the same
    Krylov iterations, phase A's first AGREE main steps to 1e-4 relative
    with equal Krylov iterations (phase A is f32 throughout, so the two
    trajectories part at the f32 rounding level; the Krylov solves stop at
    rtol 1e-2, where such a change has not yet moved an iteration count),
    phase A's main steps within A_STEPS of the JAX run's, phase B's
    starting CFL within CFL_B (relative) and equal to phase A's last.
    The starting CFL is not the same to rounding: it is the product of
    phase A's residual ratios to the power 0.25-0.3, and the two f32
    trajectories part step by step (on this mesh by 3e-7 at the starter's
    first step, 7e-5 at phase A's second main step, 2e-4 by its ninth and
    1-7% over its last six, as the residual falls toward the f32 floor),
    so the CFLs part too: 4,347.2 here against the JAX run's 4,268.0
    (1.9%);
  - records/torch_two_phase_history.json, the port's 160x80 runs of both
    forms (records/torch_two_phase_history.py), meets the limits of
    records/jax_two_phase_history.json (chip_smoke.two_phase_vs_record),
    compared afresh from the histories;
  - the record is the JAX package's: its forms, gate and totals as the
    JAX package adds them;
  - the bench form's wiring: phase A an f32 SteadyBackwardEuler to the
    gate at CFL 500 -> 5000, phase B at phase A's last CFL, totals added.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from chip_smoke import two_phase_vs_record
from fvens_tpu_torch.cases import bench_case, bigmesh_case, precision
from fvens_tpu_torch.solver.steady import SolveInfo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "records"))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax_two_phase_history as JREC  # noqa: E402

LIVE_MESH = (32, 16)
GATE = 1e-3
AGREE = 5
A_STEPS = 1          # phase A's main steps, at most this far apart
CFL_B = 0.05         # phase B's starting CFL, relative


def _load(name):
    with open(os.path.join(ROOT, "records", name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def live():
    import bench_bigmesh
    case, mesh, u0 = bench_bigmesh.build_case(*LIVE_MESH, platform="cpu",
                                              banded=True, tol=1e-16)
    solve = bench_bigmesh._two_phase_solve(case, mesh, u0, GATE, 1e-16, 0)
    with JREC._Recorder(stop_after={2: 1}) as rec:
        with pytest.raises(JREC._Stop):
            solve()
    jax_rows = [c["rows"] for c in rec.calls]
    assert [c["dtype"] for c in rec.calls] == ["float32", "float32",
                                              "float64"]
    pcase, cm, pu0 = bigmesh_case.build_case("cpu", *LIVE_MESH)
    scheduled = precision.case_two_phase(pcase, cm, GATE)
    u, info = scheduled(pu0.to(torch.float32), max_steps=1)
    return jax_rows, u, info


def test_live_phase_a_starter_matches(live):
    (jst, _, _), _, info = live
    assert [h[4] for h in info.starter.history] == [r[3] for r in jst]
    for h, r in zip(info.starter.history, jst):
        assert abs(h[2] - r[1]) <= 1e-4 * r[1], h[0]


def test_live_phase_a_main_steps_agree(live):
    (_, ja, _), _, info = live
    assert len(info.a.history) >= AGREE and len(ja) >= AGREE
    for h, r in zip(info.a.history[:AGREE], ja):
        assert h[0] == r[0] and h[4] == r[3], (h, r)
        assert abs(h[2] - r[1]) <= 1e-4 * r[1], (h, r)
    assert abs(info.a.steps - len(ja)) <= A_STEPS
    assert info.a.finalres <= GATE < info.a.history[-2][2]


def test_live_phase_b_starts_where_jax_does(live):
    (_, ja, jb), u, info = live
    assert info.cfl_b == info.a.history[-1][3] == info.b.history[0][3]
    assert abs(info.cfl_b - jb[0][2]) <= CFL_B * jb[0][2]
    assert jb[0][2] == ja[-1][2]
    assert u.dtype == torch.float64 and bool(torch.isfinite(u).all())
    assert info.b.steps == 1 and info.steps == info.a.steps + 1
    assert info.total_lin_iters == (info.a.total_lin_iters
                                    + info.b.total_lin_iters)


def test_torch_record_meets_the_jax_record_limits():
    spec = importlib.util.spec_from_file_location(
        "torch_two_phase_history",
        os.path.join(ROOT, "records", "torch_two_phase_history.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jrec, trec = _load("jax_two_phase_history.json"), _load(
        "torch_two_phase_history.json")
    assert trec["limits"] == jrec["limits"] == JREC.LIMITS
    assert set(trec["runs"]) == {"cylinder", "bench"}
    assert set(jrec["runs"]) == {"cylinder", "bench", "cylinder_blocked"}
    for name, run in trec["runs"].items():
        got = two_phase_vs_record(name, run, jrec)
        assert json.loads(json.dumps(got)) == run["vs_record"]
        assert all(v for k, v in got.items() if k.endswith("_ok")), (name,
                                                                     got)


def test_the_record_is_the_jax_packages():
    jrec = _load("jax_two_phase_history.json")
    assert jrec["gate"] == GATE == JREC.GATE == precision.DEFAULT_GATE
    cyl, bench = jrec["runs"]["cylinder"], jrec["runs"]["bench"]
    assert cyl["form"] == "scripts/bench_bigmesh.py:_two_phase_solve"
    assert bench["form"] == "bench.py:run_solve(two_phase=)"
    a, b = cyl["phase_a"]["main"], cyl["phase_b"]
    assert cyl["steps"] == a["steps"] + b["steps"]
    # the totals count the Krylov iterations of retried steps too, the
    # histories only the accepted steps'
    logged = a["krylov_iters"] + b["krylov_iters"]
    assert cyl["krylov_iters"] >= logged
    assert (cyl["krylov_iters"] == logged) == (cyl["recoveries"] == 0)
    assert b["cfl_init"] == a["history"][-1][2]
    assert a["final_res"] <= GATE < a["history"][-2][1]
    assert cyl["converged"] and cyl["final_abs_res"] <= bigmesh_case.TOL_ABS
    ba = bench["phase_a"]["main"]
    assert ba["final_res"] <= GATE and bench["phase_b"]["cfl_init"] \
        == ba["history"][-1][2]
    assert len(bench["phase_b"]["history"]) == JREC.B_STEPS


def test_bench_form_wiring(monkeypatch):
    """solver_two_phase's phases, with SteadyBackwardEuler.solve replaced
    by a stub that records what each phase is given."""
    from fvens_tpu_torch.solver import steady
    calls = []

    def fake_solve(self, mesh, u0, log_every=0, logger=None, max_steps=None):
        calls.append((self.cfg, mesh.dtype, u0.dtype, max_steps))
        info = SolveInfo(converged=True, steps=3, total_lin_iters=7,
                         initres=1.0, finalres=1e-4)
        info.history = [(s, 0.0, 0.0, 600.0 + s, 2) for s in (1, 2, 3)]
        return u0 * 1.0, info
    monkeypatch.setattr(steady.SteadyBackwardEuler, "solve", fake_solve)
    solve, cm = bench_case.run_solve("cpu", mesh=(16, 8), two_phase=2e-3,
                                     banded=False)
    u, info = solve(max_steps=4)
    (pa, ma, ua, sa), (pb, mb, ub, sb) = calls
    assert (ma, ua, sa) == (torch.float32, torch.float32, None)
    assert (mb, ub, sb) == (torch.float64, torch.float64, 4)
    assert dataclasses.asdict(pa) == dataclasses.asdict(dataclasses.replace(
        pb, cfl_init=500.0, tol_abs=2e-3, maxiter=600))
    assert (pa.cfl_init, pa.cfl_fin, pa.tol) == (500.0, 5000.0, 1e-16)
    assert pb.cfl_init == info.cfl_b == 603.0
    assert pb.tol_abs == bench_case.TOL_ABS
    assert (info.steps, info.total_lin_iters) == (6, 14)
    assert u.dtype == torch.float64
    assert info.report()["phase_b"]["cfl_init"] == 603.0
    assert np.isfinite(info.report()["phase_a"]["wall_s"])


def test_the_f32_mesh_carries_every_field_the_banded_path_reads():
    """Phase A's mesh is CompiledMesh.to(torch.float32): every field is
    kept (index fields int64, the rest f32 and equal to the f64 values
    rounded), and the band analysis of the copy is the f64 mesh's."""
    import dataclasses as dc
    from fvens_tpu_torch.mesh.device_mesh import tensor_fields
    from fvens_tpu_torch.solver.banded import banded_structure
    _, cm, _ = bigmesh_case.build_case("cpu", 16, 8)
    cm32 = cm.to(torch.float32)
    for name in tensor_fields():
        a, b = getattr(cm, name), getattr(cm32, name)
        assert a.shape == b.shape, name
        if a.is_floating_point():
            assert b.dtype == torch.float32, name
            assert torch.equal(b, a.to(torch.float32)), name
        else:
            assert b.dtype == a.dtype and torch.equal(a, b), name
    b64, b32 = banded_structure(cm), banded_structure(cm32)
    assert b64 is not None
    for f in dc.fields(b64):
        x, y = getattr(b64, f.name), getattr(b32, f.name)
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), f.name


def test_precision_runner_options(monkeypatch, capsys):
    """python -m fvens_tpu_torch.cases.precision: --two-phase alone is
    bench.py's gate 1e-3, --mesh NIxNJ, --no-warmup; a card it cannot
    find is a one-line error and exit 1 (run_solve stubbed)."""
    seen = {}

    def fake(dev, mesh, warmup, two_phase):
        seen.update(dev=dev, mesh=mesh, warmup=warmup, two_phase=two_phase)
        return None, {"two_phase": two_phase}
    monkeypatch.setattr(bigmesh_case, "run_solve", fake)
    assert precision.main(["cylinder", "--mesh", "48x24", "--two-phase",
                           "--device", "cpu", "--no-warmup"]) == 0
    assert seen == dict(dev="cpu", mesh=(48, 24), warmup=False,
                        two_phase=1e-3)
    assert json.loads(capsys.readouterr().out) == {"two_phase": 1e-3}
    assert precision.main(["--two-phase", "2e-4", "--device", "cpu"]) == 0
    assert seen["mesh"] == bigmesh_case.BIGMESH and seen["two_phase"] == 2e-4
    capsys.readouterr()
    if not torch.cuda.is_available():
        assert precision.main(["cylinder"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
