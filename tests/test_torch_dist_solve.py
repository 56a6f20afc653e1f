"""The solver paths of the port's domain-decomposed path against the JAX
package's, on the CPU at f64, in gloo worlds of D = 2 and 4 ranks against
D of the 8 virtual CPU devices (tests/test_torch_dist.py says how), at
the tolerances of tests/test_dist.py:

  - banded with the parts' rest lists against the gather path, bsgs x4 at
    rtol 1e-10 (res 1e-12; u 1e-7, 1e-10), each against the JAX package's
    step too;
  - a zero warm start against the cold step (1e-12, equal iterations);
  - GCRO-DR: the reduced Gram of the harvested space = I to 1e-6, the
    step equal to the plain one (res 1e-12; u 1e-7, 1e-9), and a second
    step recycling the space finite;
  - the first 20 steps of the distributed main solve (the cylinder case
    at f64 on cylinder_omesh(32, 12), banded bsgs x6 with the rest lists)
    step for step against DistributedBackwardEuler's history: equal
    Krylov iterations, residuals to 1e-9 relative with a floor of 1e-12
    of the first (the CLI tests' rule).
"""

import dataclasses
from functools import partial

import jax
import numpy as np
import pytest

from fvens_tpu.cases.casesolvers import build_space as jax_build_space
from fvens_tpu.config import LinearSolverConfig as JLinear
from fvens_tpu.config import NonlinearUpdateConfig as JNonlinear
from fvens_tpu.config import PseudoTimeConfig as JPseudoTime
from fvens_tpu.dist.shard import DistributedBackwardEuler as JDBE
from fvens_tpu.solver.steady import ToleranceError as JToleranceError

import torch_dist_ranks as R
from test_torch_dist import WORLDS, jax_flow, jax_space, jax_step, port_world
from test_torch_residual import to_jax_config


def port(D: int) -> dict:
    return port_world(R.solver_paths, D)


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_banded_step_matches_gather(D):
    """The banded step with the parts' rest lists against the gather step
    (the same Newton direction up to summation order), each against the
    JAX package's."""
    st = port(D)["banded"]
    ug, rg, _, blg = st[False]
    ub, rb, _, blb = st[True]
    assert blb and not blg
    np.testing.assert_allclose(rb, rg, rtol=1e-12)
    np.testing.assert_allclose(ub, ug, rtol=1e-7, atol=1e-10)
    sf = jax_flow(jax_space(), D)
    for banded, (u, res) in ((False, (ug, rg)), (True, (ub, rb))):
        ju, jres, _ = jax_step(sf, D, pc="bsgs", pc_sweeps=4, banded=banded,
                               **R.TIGHT)
        np.testing.assert_allclose(res, jres, rtol=1e-12)
        np.testing.assert_allclose(u, ju, rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_warmstart_matches_cold(D):
    kr = port(D)["krylov"]
    uc, rc, itc = kr["cold"]
    uw, rw, itw, finite = kr["warm"]
    assert finite and itw == itc
    np.testing.assert_allclose(uw, uc, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(rw, rc, rtol=1e-12)
    sf = jax_flow(jax_space(order2=False), D, mesh=(24, 10))
    ju, jres, jit = jax_step(sf, D, restart=40, maxiter=40, rtol=1e-8,
                             rtol_adapt=False, pc="bjacobi", warm_start=True)
    np.testing.assert_allclose(uc, ju, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(rc, jres, rtol=1e-12)
    assert itc == jit


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_deflated_step_matches_and_recycles(D):
    kr = port(D)["krylov"]
    up, rp, _ = kr["plain"]
    ud, rd, _, gram = kr["deflated"]
    np.testing.assert_allclose(gram, np.eye(gram.shape[0]), atol=1e-6)
    np.testing.assert_allclose(rd, rp, rtol=1e-12)
    np.testing.assert_allclose(ud, up, rtol=1e-7, atol=1e-9)
    assert kr["recycled"]
    sf = jax_flow(jax_space(order2=False), D, mesh=(24, 10))
    lin = dict(restart=60, maxiter=60, rtol=1e-10, rtol_adapt=False,
               pc="bjacobi")
    be = JDBE(space=sf.space, cfg=JPseudoTime(), lin=JLinear(
        deflation_k=6, **lin), nl=JNonlinear(scheme="full"), flow=sf)
    ju, jres, _, _ = jax.jit(partial(be._step, return_defl=True))(
        sf.dist_mesh(), sf.initial_state(), 50.0, 1e-10)
    np.testing.assert_allclose(rd, float(jres), rtol=1e-12)
    np.testing.assert_allclose(ud, sf.gather_solution(np.asarray(ju)),
                               rtol=1e-7, atol=1e-9)


class _History:
    """A ConvergenceLogger stand-in that keeps every accepted step."""

    def __init__(self):
        self.rows = []

    def log(self, step, relres, res, lin_iters=0, cfl=0.0, **kw):
        self.rows.append((step, relres, res, cfl, lin_iters))


@pytest.mark.parametrize("D", WORLDS)
def test_distributed_solve_history_matches_jax(D):
    """The first R.HISTORY_STEPS steps of the distributed main solve, step
    for step against DistributedBackwardEuler's history in the JAX
    package: equal Krylov iterations, residuals to 1e-9 relative with a
    floor of 1e-12 of the first."""
    got = port(D)["history"]
    jcfg = to_jax_config(R.history_case())
    sf = jax_flow(jax_build_space(jcfg), D, stretch=1.15 ** (20.0 / 12))
    log = _History()
    with pytest.raises(JToleranceError):
        sf.solve_implicit(dataclasses.replace(
            jcfg.main, maxiter=R.HISTORY_STEPS), lin=jcfg.linear,
            nl=jcfg.nl_update, logger=log)
    assert len(got) == len(log.rows) == R.HISTORY_STEPS
    floor = 1e-12 * log.rows[0][2]
    for g, w in zip(got, log.rows):
        assert g[4] == w[4], (g, w)
        assert abs(g[2] - w[2]) <= max(1e-9 * abs(w[2]), floor), (g, w)


def test_one_rank_case_equals_the_single_device_case():
    """DistributedFlowCase on one rank (the chip's G1 layout) is the
    single-device SteadyFlowCase: a one-part partition is the compiled
    mesh and a one-rank reduction changes no sum, so with GMRES on the
    classic path of both (16x8 takes it by itself) the starter, every
    main step and the functionals are equal to the bit."""
    import torch

    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.cases.casesolvers import build_space
    from fvens_tpu_torch.output import entropy_error, surface_data
    got = port_world(partial(R.case_run, mesh=(16, 8)), 1)
    case, cm, u0 = bigmesh_case.build_case("cpu", 16, 8)
    u, info = case.solve(cm, u0)
    space = build_space(R.case_config())
    want = [entropy_error(space, cm, u)] + [
        float(x) for x in surface_data(space, cm, u, (2,))[1]]
    st = case.starter_info
    assert got["starter"] == (st.steps, st.total_lin_iters)
    assert got["history"] == info.history
    assert got["functionals"] == want
    assert torch.isfinite(u).all()


RECORD_STARTER_STEPS = 4


def test_jax_dist_record_is_the_cylinder_case():
    """records/jax_dist_history.json, which chip_smoke.py's phase G3 holds
    the card's 160x80 distributed solves to, records the port's cylinder
    case (cases/bigmesh_case.py) at D = 2 and 4 under the BFS and the
    contiguous-block partitions, states its limits and is self-consistent;
    and the port's first RECORD_STARTER_STEPS starter steps of the D = 2
    contiguous-block run on the CPU follow it: equal Krylov iterations,
    residuals within the record's agree_res."""
    import json
    import os

    import chip_smoke
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, chip_smoke.JAX_DIST_RECORD)) as f:
        rec = json.load(f)
    cfg = dataclasses.replace(R.case_config(), wall_markers=())
    assert rec["case"]["config"] == json.loads(json.dumps(
        dataclasses.asdict(to_jax_config(cfg))))
    assert set(rec["limits"]) == {"agree_steps", "agree_iters", "agree_res",
                                  "main_steps", "krylov_iters",
                                  "near_tol", "functionals", "cl_abs"}
    assert {(r["parts"], r["partition"]) for r in rec["runs"]} == {
        (D, p) for D in chip_smoke.DIST_PARTS for p in ("bfs", "blocks")}
    for r in rec["runs"]:
        assert r["converged"] and r["mesh"] == "cylinder_omesh({}, {})" \
            .format(*chip_smoke.DIST_CHECK_MESH)
        for part in ("starter", "main"):
            h = r[part]["history"]
            assert [x[0] for x in h] == list(range(1, r[part]["steps"] + 1))
            assert sum(x[3] for x in h) == r[part]["krylov_iters"]
    want = next(r for r in rec["runs"] if r["parts"] == 2
                and r["partition"] == "blocks")["starter"]["history"]
    got = port_world(partial(R.case_run, mesh=chip_smoke.DIST_CHECK_MESH,
                             main_steps=0,
                             starter_steps=RECORD_STARTER_STEPS,
                             blocks=True), 2)["starter_history"]
    assert len(got) == RECORD_STARTER_STEPS
    for g, (step, res, _, its) in zip(got, want):
        assert g[4] == its, step
        assert abs(g[2] - res) <= rec["limits"]["agree_res"] * res, step


def test_torch_dist_record_meets_the_jax_record_limits():
    """records/torch_dist_history.json, the port's 160x80 distributed runs
    on the CPU (records/torch_dist_history.py), covers every run of
    records/jax_dist_history.json, and each run, compared afresh from its
    histories, meets the JAX record's limits: the starter equal, the first
    agree_steps main steps step for step, converged within the totals'
    bounds from above and below, the functionals."""
    import importlib.util
    import json
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_dist_history",
        os.path.join(root, "records", "torch_dist_history.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(mod.RECORD) as f:
        jrec = json.load(f)
    with open(os.path.join(root, "records", "torch_dist_history.json")) as f:
        trec = json.load(f)
    lim = jrec["limits"]
    assert trec["limits"] == lim
    assert {(r["parts"], r["partition"]) for r in trec["runs"]} == {
        (r["parts"], r["partition"]) for r in jrec["runs"]}
    for run in trec["runs"]:
        want = next(r for r in jrec["runs"] if r["parts"] == run["parts"]
                    and r["partition"] == run["partition"])
        got = mod.compare(run, want, lim,
                          jrec["case"]["config"]["main"]["tol_abs"])
        assert json.loads(json.dumps(got)) == run["vs_record"]
        assert all(got[k] for k in (
            "converged", "starter_ok", "agree_steps_ok",
            "totals_from_above_ok", "totals_from_below_ok",
            "functionals_ok")), (run["parts"], run["partition"], got)
