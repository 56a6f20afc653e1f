"""The port's distributed dry run (fvens_tpu_torch/entry.py:
dryrun_multichip) and its single distributed implicit step
(dist/shard.py: ShardedFlow.be_step) against the JAX package's, on the CPU.

  - ShardedFlow.be_step in a gloo world of 2 ranks against
    ShardedFlow.be_step_fn live on 2 of the 8 virtual CPU devices of
    tests/conftest.py, on the dry run's f32 case from the free stream at
    CFL 50 (tests/torch_dist_ranks.py: BE_STEPS): the residual to 1e-5
    relative (f32), equal Krylov iterations, the new state to 1e-4;
  - dryrun_multichip(2, device="cpu") against
    records/jax_dryrun_history.json (the JAX function's run at D = 2;
    records/jax_dryrun_history.py): equal halo statistics, equal Krylov
    iterations of the five single steps, every residual to 1e-5 relative
    (the record's full-precision free-stream residual, which each of the
    five printed residuals rounds), equal mini-solve steps, and the
    mini-solves' Krylov iterations within the record's LIMITS (10%: the
    f32 trajectories of the two packages part at rounding level, and an
    ILU0 or SGS Krylov solve that stops at rtol 1e-2 then takes one
    iteration more or fewer now and then);
  - the record is the JAX function's: its source hash and configuration,
    its lines parse to its numbers, and its D = 8 line is the one
    MULTICHIP_r05.json holds;
  - `python -m fvens_tpu_torch.entry --devices 1 --device cpu` runs
    entry() and the dry run and prints the line and its route.
"""

import hashlib
import inspect
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fvens_tpu.config import BCSpec as JBCSpec
from fvens_tpu.config import LinearSolverConfig as JLinear
from fvens_tpu.config import NonlinearUpdateConfig as JNonlinear
from fvens_tpu.config import NumericsConfig as JNumerics
from fvens_tpu.config import PhysicsConfig as JPhysics
from fvens_tpu.dist import ShardedFlow as JShardedFlow
from fvens_tpu.dist import partition_mesh as jax_partition
from fvens_tpu.fv.residual import FlowFV as JFlowFV
from fvens_tpu.mesh.meshgen import cylinder_omesh as jax_cylinder
from fvens_tpu.physics import GasPhysics as JGas
from fvens_tpu_torch.dist import launch
from fvens_tpu_torch.entry import dryrun_multichip

import torch_dist_ranks as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "records"))

import jax_dryrun_history as REC  # noqa: E402

with open(os.path.join(ROOT, "records", "jax_dryrun_history.json")) as f:
    RECORD = json.load(f)
RUN2 = next(r for r in RECORD["runs"] if r["parsed"]["n_devices"] == 2)
STEPS = ("implicit", "matrix_free", "banded", "deflated")
RES_RTOL = 1e-5


@pytest.fixture(scope="module")
def be_steps():
    return launch.run(R.be_steps, 2, device="cpu", threads=1, timeout=60,
                      join_timeout=300)[0]


def _jax_be_step(lin, rtol):
    pcfg = JPhysics(Minf=0.38, viscous=True)
    ncfg = JNumerics(flux="HLLC", gradient="LEASTSQUARES",
                     reconstruction="LINEAR", order2=True)
    phy = JGas(g=pcfg.gamma, Minf=pcfg.Minf, Tinf=pcfg.Tinf,
               Reinf=pcfg.Reinf, Pr=pcfg.Pr)
    space = JFlowFV(phy=phy, pcfg=pcfg, ncfg=ncfg)
    bcs = [JBCSpec(marker=2, type="adiabaticwall", values=(0.0,)),
           JBCSpec(marker=4, type="farfield")]
    sf = JShardedFlow(space=space, bundle=jax_partition(
        jax_cylinder(16, 6), bcs, 2, dtype=jnp.float32),
        devices=jax.devices()[:2])
    step = sf.be_step_fn(lin=JLinear(**lin),
                         nl=JNonlinear(scheme="robust_flow"))
    u1, res, it = step(sf.initial_state(), 50.0, rtol)
    return sf.gather_solution(np.asarray(u1)), float(res), int(it)


@pytest.mark.parametrize("name,lin,rtol", R.BE_STEPS,
                         ids=[s[0] for s in R.BE_STEPS])
def test_be_step_matches_jax_be_step_fn(be_steps, name, lin, rtol):
    u1, res, it = be_steps[name]
    ju, jres, jit = _jax_be_step(lin, rtol)
    assert np.isfinite(res) and np.isfinite(u1).all()
    assert abs(res - jres) <= RES_RTOL * abs(jres)
    assert it == jit
    np.testing.assert_allclose(u1, ju, rtol=1e-4, atol=1e-4 * np.abs(
        ju).max())


@pytest.fixture(scope="module")
def dryrun():
    return dryrun_multichip(2, device="cpu")


def test_dryrun_halo_statistics_equal_the_record(dryrun):
    assert dryrun["halo"] == RUN2["parsed"]["halo"]


def test_dryrun_krylov_iterations_equal_the_record(dryrun):
    for k in STEPS:
        assert dryrun["steps"][k]["krylov_iters"] \
            == RUN2["parsed"]["steps"][k]["krylov_iters"], k


def test_dryrun_residuals_agree_with_the_record(dryrun):
    """Every residual is the free stream's (each step starts there): the
    record's full-precision value is the first mini-solve step's, and each
    printed residual of the record is it rounded."""
    ref = RUN2["mini_solve_history"]["bcsgs"][0][1]
    p = RUN2["parsed"]
    for printed in [p["explicit_res"]] + [p["steps"][k]["res"]
                                          for k in STEPS]:
        assert float(f"{ref:.3e}") == printed
    got = [dryrun["explicit_res"]] + [dryrun["steps"][k]["res"]
                                      for k in STEPS]
    got += [dryrun["mini_solves"][pc]["history"][0][1]
            for pc in ("bcsgs", "ilu0")]
    for g in got:
        assert abs(g - ref) <= RES_RTOL * ref, (g, ref)


def test_dryrun_mini_solves_agree_with_the_record(dryrun):
    lim = RECORD["limits"]["lin_iters"]
    for pc in ("bcsgs", "ilu0"):
        got = dryrun["mini_solves"][pc]
        want = RUN2["parsed"]["mini_solves"][pc]
        assert got["steps"] == want["steps"], pc
        assert abs(got["lin_iters"] - want["lin_iters"]) \
            <= lim * want["lin_iters"], (pc, got["lin_iters"])
        assert len(got["history"]) == got["steps"]


def test_dryrun_line_is_the_jax_line(dryrun):
    """The port's line is the JAX function's word for word, "exchange
    rounds" in place of "ppermute rounds", and parses to its numbers."""
    line = dryrun["line"]
    parsed = REC.parse_line(line)
    assert parsed["halo"] == dryrun["halo"]
    for pc in ("bcsgs", "ilu0"):
        assert parsed["mini_solves"][pc] == {
            k: dryrun["mini_solves"][pc][k] for k in ("steps", "lin_iters")}

    def words(s):
        return re.sub(r"[-+0-9.e]+(?=[ ),;])|\d+", "#", s)
    assert words(line) == words(RUN2["line"].replace("ppermute", "exchange"))
    assert dryrun["route"] == "gloo" and dryrun["device"] == "cpu"


def test_the_record_is_the_jax_functions():
    import __graft_entry__ as graft
    src = inspect.getsource(graft.dryrun_multichip)
    assert RECORD["source_sha256"] == hashlib.sha256(
        src.encode()).hexdigest()
    assert RECORD["config"] == json.loads(json.dumps(REC.CONFIG))
    flat = re.sub(r"\s+", " ", src)
    for text in ("cylinder_omesh(8 * n_devices, 6)",
                 "PhysicsConfig(Minf=0.38, viscous=True)",
                 'flux="HLLC", gradient="LEASTSQUARES", '
                 'reconstruction="LINEAR", order2=True',
                 'BCSpec(marker=2, type="adiabaticwall", values=(0.0,))',
                 'BCSpec(marker=4, type="farfield")', "dtype=jnp.float32",
                 "sf.fe_step_fn(cfl=0.5)",
                 "LinearSolverConfig(restart=20, maxiter=20, rtol=1e-1, "
                 "rtol_adapt=False)", 'scheme="robust_flow"',
                 "bstep(sf.initial_state(), 50.0, 0.1)",
                 "matrix_free=True", 'pc="bsgs", banded=True',
                 "deflation_k=4",
                 "PseudoTimeConfig(cfl_init=25.0, cfl_fin=500.0, tol=1e-4, "
                 "maxiter=150)",
                 "LinearSolverConfig(restart=30, maxiter=30, rtol=1e-2, "
                 "pc=pc, pc_sweeps=3 if pc == \"ilu0\" else 1)",
                 'for pc in ("bcsgs", "ilu0")'):
        assert text in flat, text
    assert [r["parsed"]["n_devices"] for r in RECORD["runs"]] == [2, 4, 8]
    for r in RECORD["runs"]:
        assert REC.parse_line(r["line"]) == r["parsed"]
        for pc in ("bcsgs", "ilu0"):
            h = r["mini_solve_history"][pc]
            assert len(h) == r["parsed"]["mini_solves"][pc]["steps"]
            assert sum(x[3] for x in h) \
                == r["parsed"]["mini_solves"][pc]["lin_iters"]
    with open(os.path.join(ROOT, "MULTICHIP_r05.json")) as f:
        tail = json.load(f)["tail"]
    assert RECORD["runs"][2]["line"] in tail


def test_entry_module_runs_entry_and_the_dry_run():
    proc = subprocess.run(
        [sys.executable, "-m", "fvens_tpu_torch.entry", "--devices", "1",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "entry(): forward step ok"
    parsed = REC.parse_line(lines[1])
    assert parsed["n_devices"] == 1 and parsed["halo"]["halo_cells"] == 0
    assert lines[2].startswith("dryrun_multichip(1): 1 ranks (gloo) on cpu")


def test_chip_smoke_holds_the_cpu_dry_run_to_the_record(dryrun):
    """chip_smoke.py's phase H2 comparison, on the CPU run: every verdict
    holds."""
    from chip_smoke import dryrun_vs_record
    vs = dryrun_vs_record(dryrun, RUN2, RECORD["limits"])
    assert all(v for k, v in vs.items() if k.endswith("_ok")), vs
    assert dryrun["launches"] == {"banded_apply": 0, "banded_bsgs": 0,
                                  "row_set": 0}
