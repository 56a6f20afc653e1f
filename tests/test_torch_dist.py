"""The domain-decomposed path of the port (fvens_tpu_torch/dist/) against
the JAX package's (fvens_tpu/dist/), on the CPU at f64: the sharded
functions. tests/test_torch_dist_steps.py holds the implicit steps and
tests/test_torch_dist_solve.py the solver paths; this file's helpers serve
both.

The port runs in gloo worlds of D = 2 and 4 ranks started by
dist/launch.py, one world per D and file (the rank functions are in
tests/torch_dist_ranks.py, which imports no jax); the JAX package runs the
same inputs on D of the 8 virtual CPU devices of tests/conftest.py. One
case for each test of tests/test_dist.py:48-465 that runs a sharded
function, at that test's tolerance; here:

  - the sharded residual of the six scheme cases at a smooth state
    (rtol 1e-10, atol 1e-12; dt atol 1e-14), against the JAX package's
    sharded and single-device residuals;
  - the neighbour schedule against the all-gather exchange (equal), and
    the port's exchange against the JAX package's ppermute (equal);
  - one forward-Euler step (1e-11, 1e-13; the norm 1e-11);
  - casesolvers.DistributedFlowCase.run_output (starting its own two
    ranks) against the JAX package's on the cylinder case at 24x10: equal
    steps and Krylov iterations, functionals to 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fvens_tpu.config import BCSpec as JBCSpec
from fvens_tpu.config import LinearSolverConfig as JLinear
from fvens_tpu.config import NonlinearUpdateConfig as JNonlinear
from fvens_tpu.config import NumericsConfig as JNumerics
from fvens_tpu.config import PhysicsConfig as JPhysics
from fvens_tpu.config import PseudoTimeConfig as JPseudoTime
from fvens_tpu.dist import ShardedFlow as JShardedFlow
from fvens_tpu.dist import partition_mesh as jax_partition
from fvens_tpu.dist.shard import AXIS, DistributedBackwardEuler as JDBE
from fvens_tpu.dist.shard import halo_exchange as jax_halo_exchange
from fvens_tpu.fv.residual import FlowFV as JFlowFV
from fvens_tpu.mesh import compile_mesh as jax_compile_mesh
from fvens_tpu.mesh.meshgen import cylinder_omesh as jax_cylinder
from fvens_tpu.physics import GasPhysics as JGas
from fvens_tpu_torch.dist import launch

import torch_dist_ranks as R

JBCS = [JBCSpec(marker=2, type="slipwall"), JBCSpec(marker=4, type="farfield")]
WORLDS = (2, 4)
_PORT = {}


def port_world(fn, D: int):
    """Rank 0's result of fn (a tests/torch_dist_ranks.py function) in one
    gloo world of D ranks, run once per file and D: a 60 s process-group
    timeout, a 300 s join timeout, one torch thread per rank."""
    key = (repr(fn), D)
    if key not in _PORT:
        _PORT[key] = launch.run(fn, D, device="cpu", threads=1, timeout=60,
                                join_timeout=300)[0]
    return _PORT[key]


def port(D: int) -> dict:
    return port_world(R.sharded_functions, D)


def jax_space(order2=True, viscous=False, recon="LINEAR"):
    pcfg = JPhysics(Minf=0.38, viscous=viscous,
                    Reinf=100.0 if viscous else 1.0)
    ncfg = JNumerics(flux="HLLC", gradient="LEASTSQUARES",
                     reconstruction=recon, order2=order2)
    phy = JGas(g=pcfg.gamma, Minf=pcfg.Minf, Tinf=pcfg.Tinf,
               Reinf=pcfg.Reinf, Pr=pcfg.Pr)
    return JFlowFV(phy=phy, pcfg=pcfg, ncfg=ncfg)


def jax_flow(space, D, mesh=(32, 12), **kw):
    md = jax_cylinder(*mesh, **kw)
    return JShardedFlow(space=space, bundle=jax_partition(md, JBCS, D),
                        devices=jax.devices()[:D])


def jax_step(sf, D, u=None, **lin):
    """One JAX DistributedBackwardEuler step at CFL 50 from u (default the
    free stream) with LinearSolverConfig(**lin): (u gathered, res, iters)."""
    be = JDBE(space=sf.space, cfg=JPseudoTime(), lin=JLinear(**lin),
              nl=JNonlinear(scheme="full"), flow=sf)
    dm = sf.dist_mesh()
    u1, res, it = jax.jit(be._step)(
        dm, sf.initial_state() if u is None else u, 50.0, lin["rtol"],
        bl=be._banded(dm))
    return sf.gather_solution(np.asarray(u1)), float(res), int(it)



@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("scheme", R.SCHEMES, ids=lambda s: "-".join(
    str(x) for x in s))
def test_sharded_residual_matches_jax(D, scheme):
    order2, recon, viscous = scheme
    rhs, dt = port(D)["residuals"][scheme]
    space = jax_space(order2=order2, viscous=viscous, recon=recon)
    cm = jax_compile_mesh(jax_cylinder(32, 12), JBCS)
    rc = np.asarray(cm.rc)
    pert = 0.05 * np.sin(rc[:, 0]) * np.cos(rc[:, 1])
    u = (np.tile(np.asarray(space.uinf), (cm.NC, 1))
         * (1.0 + pert[:, None] * np.array([1.0, 0.5, -0.5, 1.0])))
    sf = jax_flow(space, D)
    b = sf.bundle
    gid = np.asarray(b.own_gid)
    u_loc = np.tile(np.asarray(space.uinf), (D, b.mesh.NC, 1))
    for p in range(D):
        n = int(b.own_counts[p])
        u_loc[p, :n] = u[gid[p, :n]]
    jrhs, jdt = jax.jit(sf.residual)(jnp.asarray(u_loc))
    np.testing.assert_allclose(rhs, sf.gather_solution(jrhs), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(
        dt, sf.gather_solution(np.asarray(jdt)[..., None])[:, 0],
        rtol=1e-10, atol=1e-14)
    # and the single-device JAX residual, as tests/test_dist.py holds it
    srhs, _ = space.compute_residual(cm, jnp.asarray(u), True)
    np.testing.assert_allclose(rhs, np.asarray(srhs)[:cm.n_cells],
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("D", WORLDS)
def test_halo_exchange_matches_allgather_and_ppermute(D):
    """The scheduled exchange fills the same slots with the same values as
    the all-gather and as the JAX package's ppermute schedule."""
    from jax.sharding import PartitionSpec as P
    pp, ag, halo = port(D)["exchanges"]
    np.testing.assert_array_equal(pp, ag)
    sf = jax_flow(jax_space(), D)
    b = sf.bundle
    field = np.random.default_rng(7).normal(size=(D, b.mesh.NC, 4))

    def via_pp(pps, ppr, f):
        return jax_halo_exchange((pps[0], ppr[0], b.pp_perms), f[0])[None]

    want = jax.jit(jax.shard_map(
        via_pp, mesh=sf.jmesh, in_specs=(P(AXIS), P(AXIS), P(AXIS)),
        out_specs=P(AXIS)))(b.pp_send, b.pp_recv, jnp.asarray(field))
    np.testing.assert_array_equal(pp, np.asarray(want))
    assert D * 0 < halo <= b.halo_cells


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_fe_step_matches_jax(D):
    u1, res = port(D)["fe"]
    sf = jax_flow(jax_space(), D)
    ju, jres = sf.fe_step_fn(cfl=0.5)(sf.initial_state())
    np.testing.assert_allclose(u1, sf.gather_solution(np.asarray(ju)),
                               rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(res, float(jres), rtol=1e-11)


def test_distributed_flow_case_run_output_matches_jax(monkeypatch):
    """casesolvers.DistributedFlowCase.run_output (the ranks started by
    itself: two gloo ranks on the CPU, a 60 s process-group timeout)
    against the JAX package's DistributedFlowCase.run_output on two
    virtual devices, on the cylinder
    case at cylinder_omesh(24, 10) with its wall marker: the same starter
    and main steps and Krylov iterations, the functionals to 1e-8 (CL,
    zero by symmetry, to 1e-12 absolute)."""
    from fvens_tpu.cases.casesolvers import DistributedFlowCase as JCase
    from fvens_tpu_torch.cases import casesolvers
    from fvens_tpu_torch.cases.casesolvers import DistributedFlowCase

    from test_torch_residual import to_jax_config
    cfg = R.case_config()
    md = R.cylinder_omesh(24, 10, stretch=1.15 ** 2)
    monkeypatch.setattr(casesolvers, "DIST_TIMEOUT", 60.0)
    case = DistributedFlowCase(cfg, 2, device="cpu")
    u, info, fnls = case.run_output(md)
    ju, jinfo, jfnls = JCase(to_jax_config(cfg), n_devices=2).run_output(
        jax_cylinder(24, 10, stretch=1.15 ** 2))
    assert u.shape == np.asarray(ju).shape
    assert (info.steps, info.total_lin_iters) == (jinfo.steps,
                                                  jinfo.total_lin_iters)
    assert case.starter_info.steps > 0
    for k in ("entropy", "CL", "CDp", "CDsf"):
        a, b = getattr(fnls, k), float(getattr(jfnls, k))
        assert abs(a - b) <= max(1e-8 * abs(b), 1e-12), k


def test_launch_defaults_to_the_card():
    """launch.run with no device and no backend starts NCCL ranks, one
    card each: with fewer cards than ranks it refuses, naming the count,
    and never falls back to gloo on the host."""
    import torch
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"{n} NCCL ranks need {n} cards"):
        launch.run(R.sharded_functions, n)
