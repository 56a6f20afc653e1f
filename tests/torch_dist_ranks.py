"""Rank entry functions of the distributed tests (tests/test_torch_dist*.py).

Every function here runs inside a rank that dist/launch.py spawned, so this
module imports torch, numpy and the port only, never jax (the test files
import both packages and hold these results against the JAX package's).
A function takes the rank's Comm and returns, on rank 0, NumPy results
gathered in global cell order (None on the other ranks where it says so).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fvens_tpu_torch.config import (BCSpec, LinearSolverConfig,
                                    NonlinearUpdateConfig, NumericsConfig,
                                    PhysicsConfig, PseudoTimeConfig)
from fvens_tpu_torch.dist.comm import (allreduce_sum, halo_exchange,
                                       halo_exchange_allgather)
from fvens_tpu_torch.dist.partition import partition_mesh
from fvens_tpu_torch.dist.shard import DistributedBackwardEuler, ShardedFlow
from fvens_tpu_torch.fv.residual import FlowFV
from fvens_tpu_torch.solver.linear import gmres, gmres_device
from fvens_tpu_torch.mesh.device_mesh import compile_mesh
from fvens_tpu_torch.mesh.meshgen import cylinder_omesh
from fvens_tpu_torch.physics.gas import GasPhysics

BCS = [BCSpec(marker=2, type="slipwall"), BCSpec(marker=4, type="farfield")]
# (order2, reconstruction, viscous) of tests/test_dist.py's residual cases
SCHEMES = ((False, "LINEAR", False), (True, "LINEAR", False),
           (True, "WENO", False), (True, "VENKATAKRISHNAN", False),
           (True, "VANALBADA", False), (True, "LINEAR", True))
TIGHT = dict(restart=80, maxiter=80, rtol=1e-10, rtol_adapt=False)
HISTORY_STEPS = 20


class NoHostRead(TorchDispatchMode):
    """Raises on an operation that reads a tensor's value on the host or
    makes a tensor from host data (on the card, a synchronizing copy)."""
    BANNED = ("_local_scalar_dense", "nonzero", "masked_select",
              "lift_fresh", "item", "is_nonzero")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        # a boolean mask index sizes its result from the mask's count
        masked = name.startswith("index") and len(args) > 1 and any(
            torch.is_tensor(i) and i.dtype == torch.bool
            for i in (args[1] or ()))
        if name in self.BANNED or masked:
            raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


def make_space(order2=True, viscous=False, recon="LINEAR") -> FlowFV:
    """tests/test_dist.py:make_space on the port."""
    pcfg = PhysicsConfig(Minf=0.38, viscous=viscous,
                         Reinf=100.0 if viscous else 1.0)
    ncfg = NumericsConfig(flux="HLLC", gradient="LEASTSQUARES",
                          reconstruction=recon, order2=order2)
    phy = GasPhysics(g=pcfg.gamma, Minf=pcfg.Minf, Tinf=pcfg.Tinf,
                     Reinf=pcfg.Reinf, Pr=pcfg.Pr)
    return FlowFV(phy=phy, pcfg=pcfg, ncfg=ncfg)


def smooth_state(space, mesh) -> np.ndarray:
    """tests/test_dist.py's smooth non-uniform state on the (NC, 4) mesh:
    free stream times a positional perturbation."""
    rc = mesh.rc.cpu().numpy()
    pert = 0.05 * np.sin(rc[:, 0]) * np.cos(rc[:, 1])
    uinf = space.uinf(torch.float64, "cpu").numpy()
    return (np.tile(uinf, (mesh.NC, 1))
            * (1.0 + pert[:, None] * np.array([1.0, 0.5, -0.5, 1.0])))


def _solver(flow, **lin):
    return DistributedBackwardEuler(
        space=flow.space, cfg=PseudoTimeConfig(),
        lin=LinearSolverConfig(**lin),
        nl=NonlinearUpdateConfig(scheme="full"), flow=flow)


def residuals(comm, mesh=(32, 12)) -> dict:
    """The sharded residual of every scheme case at smooth_state:
    {scheme: (rhs, dt)} gathered."""
    md = cylinder_omesh(*mesh)
    cm = compile_mesh(md, BCS, device="cpu")
    bundle = partition_mesh(md, BCS, comm.size)
    out = {}
    for o2, recon, visc in SCHEMES:
        space = make_space(o2, visc, recon)
        flow = ShardedFlow(space, bundle, comm)
        ug = smooth_state(space, cm)[:cm.n_cells]
        rhs, dt = flow.residual(flow.scatter(ug))
        g = flow.gather_solution(rhs), flow.gather_solution(dt[:, None])
        if comm.rank == 0:
            out[(o2, recon, visc)] = (g[0], g[1][:, 0])
    return out


def exchanges(comm, mesh=(32, 12)) -> tuple:
    """A seeded (D, NC, 4) field (rng 7) exchanged by the neighbour
    schedule and by the all-gather, each gathered stacked (D, NC, 4)."""
    from fvens_tpu_torch.dist.comm import all_gather_rows
    bundle = partition_mesh(cylinder_omesh(*mesh), BCS, comm.size)
    flow = ShardedFlow(make_space(), bundle, comm)
    rng = np.random.default_rng(7)
    field = torch.from_numpy(rng.normal(size=(comm.size, bundle.NC, 4))
                             [comm.rank])
    pp = all_gather_rows(comm, halo_exchange(flow.exch, field))
    ag = all_gather_rows(comm, halo_exchange_allgather(flow.exch, field))
    return pp.numpy(), ag.numpy(), flow.exch.halo_cells


def _flow32(comm):
    """The second-order flow of tests/test_dist.py on cylinder_omesh(32,
    12) and its free stream."""
    bundle = partition_mesh(cylinder_omesh(32, 12), BCS, comm.size)
    flow = ShardedFlow(make_space(), bundle, comm)
    return flow, flow.initial_state()


def fe_step(comm) -> tuple:
    """One forward-Euler step at CFL 0.5 from the free stream: (u, res)
    gathered."""
    flow, u0 = _flow32(comm)
    u1, res = flow.fe_step(u0, 0.5)
    return flow.gather_solution(u1), res


def implicit_steps(comm) -> dict:
    """One backward-Euler step at CFL 50 from the free stream, bjacobi at
    rtol 1e-10, with the assembled ("implicit"), exact-JVP ("mf_jvp") and
    FD ("mf_fd") matvecs: {kind: (u, res, iterations)} gathered, and
    under ("device", kind) the same of the device form (_device_step),
    run after the host step under NoHostRead."""
    flow, u0 = _flow32(comm)
    f = lambda x: torch.tensor(x, dtype=torch.float64)
    out = {}
    for name, lin in (("implicit", {}),
                      ("mf_jvp", dict(matrix_free=True)),
                      ("mf_fd", dict(matrix_free=True, matrix_free_fd=True))):
        be = _solver(flow, pc="bjacobi", **TIGHT, **lin)
        u1, res, it = be._step(flow.dist_mesh(), u0, 50.0, 1e-10)
        out[name] = (flow.gather_solution(u1), res, it)
        cfl, rtol, one = f(50.0), f(1e-10), f(1.0)
        with NoHostRead():
            u1, res, it, _ = be._device_step(flow.dist_mesh(), u0, cfl, rtol,
                                             one)
        out[("device", name)] = (flow.gather_solution(u1), float(res),
                                 int(it))
    return out


def gmres_pairs(comm) -> dict:
    """The host gmres(allreduce=) and gmres_device(allreduce=) on the
    Krylov system of one distributed implicit step (f64, bsgs x4 on slot
    gathers, the Krylov vector exchanged at every matvec, masked), for
    each (restart, maxiter, rtol) of GMRES_CASES: {case: (x host, its
    iterations, relres, x device, its iterations, relres)}, the x
    gathered."""
    flow, u0 = _flow32(comm)
    be = _solver(flow, pc="bsgs", pc_sweeps=4)
    dm = flow.dist_mesh()
    mesh = dm.mesh
    ex = partial(halo_exchange, dm.exch)
    ar = partial(allreduce_sum, comm)
    u = ex(u0)
    _, lrhs, ops = be.step_operators(mesh, u, 500.0, exchange=ex,
                                     allreduce=ar)
    mv, pc = be._linear_operators(ops)
    mask = mesh.cell_mask[:, None].to(lrhs.dtype)
    matvec = lambda x: mv(ex(x)) * mask
    pcm = lambda v: pc(v) * mask
    b = lrhs * mask
    out = {}
    for restart, maxiter, rtol in GMRES_CASES:
        xh, ih, rh = gmres(matvec, b, torch.zeros_like(b), pcm,
                           restart=restart, maxiter=maxiter, rtol=rtol,
                           blocked=False, allreduce=ar)
        xd, idv, rd = gmres_device(matvec, b, torch.zeros_like(b), pcm, rtol,
                                   restart=restart, maxiter=maxiter,
                                   allreduce=ar)
        out[(restart, maxiter, rtol)] = (
            flow.gather_solution(xh), ih, float(rh),
            flow.gather_solution(xd), int(idv), float(rd))
    return out


# (restart, maxiter, rtol) of gmres_pairs: one cycle, and restarts
GMRES_CASES = ((90, 90, 1e-6), (10, 35, 1e-10))


def banded_steps(comm) -> dict:
    """The implicit step with bsgs x4 on slot gathers (False) and banded
    with the rest lists (True): {banded: (u, res, iterations, whether a
    band analysis came)} gathered."""
    flow, u0 = _flow32(comm)
    out = {}
    for banded in (False, True):
        be = _solver(flow, pc="bsgs", pc_sweeps=4, banded=banded, **TIGHT)
        dm = flow.dist_mesh()
        bl = be._banded(dm)
        u1, res, it = be._step(dm, u0, 50.0, 1e-10, bl=bl)
        out[banded] = (flow.gather_solution(u1), res, it, bl is not None)
    return out


def krylov_options(comm) -> dict:
    """Warm start and GCRO-DR on cylinder_omesh(24, 10), first order, one
    step at CFL 50 from the free stream, gathered:
      cold / warm: bjacobi rtol 1e-8, x0 = 0 and a zero warm guess
        (u, res, iterations, [du finite]);
      plain / deflated / recycled: bjacobi rtol 1e-10 restart 60, and with
        deflation_k = 6 (u, res, iterations, the reduced Gram of the
        harvested space), then a second step recycling it (u, U finite)."""
    md = cylinder_omesh(24, 10)
    bundle = partition_mesh(md, BCS, comm.size)
    flow = ShardedFlow(make_space(order2=False), bundle, comm)
    dm, u0 = flow.dist_mesh(), flow.initial_state()
    out = {}
    lin = dict(restart=40, maxiter=40, rtol=1e-8, rtol_adapt=False,
               pc="bjacobi", warm_start=True)
    be = _solver(flow, **lin)
    u1, res, it = be._step(dm, u0, 50.0, 1e-8)
    out["cold"] = (flow.gather_solution(u1), res, it)
    u1, res, it, du, _ = be._step(dm, u0, 50.0, 1e-8,
                                  du0=torch.zeros_like(u0),
                                  return_carry=True)
    fin = allreduce_sum(comm, (~torch.isfinite(du)).sum().double())
    out["warm"] = (flow.gather_solution(u1), res, it, float(fin) == 0)
    k = 6
    lin = dict(restart=60, maxiter=60, rtol=1e-10, rtol_adapt=False,
               pc="bjacobi")
    u1, res, it = _solver(flow, **lin)._step(dm, u0, 50.0, 1e-10)
    out["plain"] = (flow.gather_solution(u1), res, it)
    be = _solver(flow, deflation_k=k, **lin)
    u1, res, it, _, U1 = be._step(dm, u0, 50.0, 1e-10, defl=True,
                                  return_carry=True)
    flat = U1.reshape(k, -1)
    gram = allreduce_sum(comm, flat @ flat.T).numpy()
    out["deflated"] = (flow.gather_solution(u1), res, it, gram)
    u2, _, _, _, U2 = be._step(dm, u1, 50.0, 1e-10, defl=True, U0=U1,
                               return_carry=True)
    bad = (~torch.isfinite(u2)).sum() + (~torch.isfinite(U2)).sum()
    out["recycled"] = float(allreduce_sum(comm, bad.double())) == 0
    return out


def history_case():
    """The port's FlowCaseConfig of the 20-step solve: the cylinder case's
    main solve (cases/bigmesh_case.py: FGMRES(90) at rtol 1e-2, bsgs x6,
    banded) in f64 from the free stream, its CFL ramp started at 50 (to
    500), where no step blows up: from the free stream at the case's 500
    the solve blows up and recovers within 20 steps, and a blowup
    amplifies rounding differences beyond any step-for-step comparison."""
    from fvens_tpu_torch.cases.bigmesh_case import case_config
    cfg = case_config(mixed_precision=False)
    return dataclasses.replace(cfg, main=dataclasses.replace(
        cfg.main, cfl_init=50.0, cfl_fin=500.0))


def history(comm, mesh=(32, 12)) -> list:
    """The first HISTORY_STEPS accepted steps of the distributed main solve
    (history_case) on cylinder_omesh(*mesh): [(step, relres, res, cfl,
    iterations)]."""
    from fvens_tpu_torch.cases.casesolvers import build_space
    cfg = history_case()
    md = cylinder_omesh(*mesh, stretch=1.15 ** (20.0 / mesh[1]))
    flow = ShardedFlow(build_space(cfg), partition_mesh(md, BCS, comm.size),
                       comm)
    _, info = flow.solve_implicit(cfg.main, lin=cfg.linear,
                                  nl=cfg.nl_update, max_steps=HISTORY_STEPS)
    return info.history


def mode_histories(comm, mesh=(32, 12)) -> dict:
    """history()'s distributed solve under the host loop and with pipeline
    and bake_mesh set (on gloo ranks on the CPU the device form of the
    step, eager): {mode: (the first HISTORY_STEPS accepted steps, the
    final state gathered, whether the solver is device_resident)}."""
    from fvens_tpu_torch.cases.casesolvers import build_space
    cfg = history_case()
    md = cylinder_omesh(*mesh, stretch=1.15 ** (20.0 / mesh[1]))
    flow = ShardedFlow(build_space(cfg), partition_mesh(md, BCS, comm.size),
                       comm)
    out = {}
    for mode, pt in (("host", {}), ("pipeline", dict(pipeline=True)),
                     ("bake_mesh", dict(bake_mesh=True))):
        be = DistributedBackwardEuler(
            space=flow.space, cfg=dataclasses.replace(cfg.main, **pt),
            lin=cfg.linear, nl=cfg.nl_update, flow=flow)
        u, info = be.solve(flow.dist_mesh(), flow.initial_state(),
                           max_steps=HISTORY_STEPS)
        out[mode] = (info.history, flow.gather_solution(u),
                     be.device_resident)
    return out


def cli_case(comm, ctrl, msh, solverc, pt) -> dict:
    """The case a --devices run of the CLI solves (cases/cli.py: `ctrl`
    on `msh` with the options file `solverc`, f64), with the
    PseudoTimeConfig fields `pt` set on the starter and the main solve: on
    rank 0 the starter's Krylov iterations per step, the main solve's
    history, steps, Krylov iterations and functionals (None elsewhere)."""
    from fvens_tpu_torch.cases.casesolvers import DistributedFlowCase
    from fvens_tpu_torch.io_config import parse_control_file
    from fvens_tpu_torch.io_config.solverc import load_solver_options
    from fvens_tpu_torch.mesh.reader import read_mesh
    cfg = parse_control_file(ctrl, mesh_file=msh)
    lin, _, _ = load_solver_options(solverc, base=cfg.linear,
                                    warn=lambda m: None)
    cfg = dataclasses.replace(
        cfg, linear=lin, main=dataclasses.replace(cfg.main, **pt),
        init=dataclasses.replace(cfg.init, **pt))
    case = DistributedFlowCase(cfg, comm.size, device="cpu")
    _, info, fnls = case.rank_run_output(comm, read_mesh(msh))
    if comm.rank != 0:
        return None
    return dict(starter_iters=[h[4] for h in case.starter_info.history],
                history=info.history, main_steps=info.steps,
                main_iters=info.total_lin_iters,
                functionals=dict(entropy=fnls.entropy, CL=fnls.CL,
                                 CDp=fnls.CDp, CDsf=fnls.CDsf))


def case_config(wall=(2,)):
    """The cylinder case (cases/bigmesh_case.py: banded bsgs x6, mixed
    precision, starter then main to 1e-10) with its wall marker."""
    from fvens_tpu_torch.cases.bigmesh_case import case_config as cyl
    return dataclasses.replace(cyl(), wall_markers=wall)


def case_run(comm, mesh, main_steps=None, starter_steps=None,
             blocks=False) -> dict:
    """DistributedFlowCase on this world: the starter's steps and Krylov
    iterations and history, the main solve's history and (rank 0)
    functionals. `main_steps`, `starter_steps`: stop the solve after that
    many steps (its PseudoTimeConfig.maxiter; an unconverged main solve's
    ToleranceError is swallowed); `blocks`: partition into contiguous index
    blocks (cell c in part c * D // n) in place of the BFS partition."""
    from fvens_tpu_torch.cases.casesolvers import DistributedFlowCase
    from fvens_tpu_torch.solver.steady import ToleranceError
    cfg = case_config()
    if main_steps is not None:
        cfg = dataclasses.replace(cfg, main=dataclasses.replace(
            cfg.main, maxiter=main_steps))
    if starter_steps is not None:
        cfg = dataclasses.replace(cfg, init=dataclasses.replace(
            cfg.init, maxiter=starter_steps))
    md = cylinder_omesh(*mesh, stretch=1.15 ** (20.0 / mesh[1]))
    n, D = md.nelem, comm.size
    part = np.minimum(np.arange(n) * D // n, D - 1) if blocks else None
    case = DistributedFlowCase(cfg, D, device="cpu")
    try:
        _, info, fnls = case.rank_run_output(comm, md, part=part)
    except ToleranceError as e:
        info, fnls = e.info, None
    st = case.starter_info
    return dict(starter=(st.steps, st.total_lin_iters),
                starter_history=st.history, history=info.history,
                functionals=None if fnls is None else
                [fnls.entropy, fnls.CL, fnls.CDp, fnls.CDsf])


def sharded_functions(comm) -> dict:
    """tests/test_torch_dist.py's checks in one world."""
    return dict(residuals=residuals(comm), exchanges=exchanges(comm),
                fe=fe_step(comm))


def solver_paths(comm) -> dict:
    """tests/test_torch_dist_solve.py's checks in one world."""
    return dict(banded=banded_steps(comm), krylov=krylov_options(comm),
                history=history(comm))


# (name, LinearSolverConfig fields, rtol) of the single distributed implicit
# steps (ShardedFlow.be_step) held against the JAX package's be_step_fn:
# the dry run's own, and a tighter solve under bsgs x2
BE_STEPS = (("dryrun", dict(restart=20, maxiter=20, rtol=1e-1,
                            rtol_adapt=False), 0.1),
            ("bsgs", dict(restart=30, maxiter=30, rtol=1e-3,
                          rtol_adapt=False, pc="bsgs", pc_sweeps=2), 1e-3))


def be_steps(comm) -> dict:
    """ShardedFlow.be_step on the dry run's f32 case (entry.dryrun_case)
    from the free stream at CFL 50, robust_flow update, for each of
    BE_STEPS: {name: (u gathered, res, iterations)}."""
    from fvens_tpu_torch.entry import dryrun_case
    space, md, bcs = dryrun_case(comm.size)
    flow = ShardedFlow(space, partition_mesh(md, bcs, comm.size), comm,
                       dtype=torch.float32)
    out = {}
    for name, lin, rtol in BE_STEPS:
        u1, res, it = flow.be_step(
            flow.initial_state(), 50.0, rtol, lin=LinearSolverConfig(**lin),
            nl=NonlinearUpdateConfig(scheme="robust_flow"))
        out[name] = (flow.gather_solution(u1), res, it)
    return out


def captured_step(comm) -> dict:
    """The cylinder case's main step (banded bsgs x6, mixed) on
    cylinder_omesh(64, 32) from a perturbed free stream on this rank's
    card: the distributed StepProgram (captured, its collectives inside)
    against the eager device-form step at two CFLs through the same
    graph: {cfl: (all outputs equal, Krylov iterations, res, the launches
    counted on the card)}, under "reduce_in_no_host_sync" whether an
    allreduce_sum runs under no_host_sync (no host synchronisation), and
    under "graph" the nodes of the step's graph captured once more
    (chip_smoke.captured_nodes: by type, at the top and inside the IF
    nodes' bodies, NCCL's kernels among them), under "masked" whether
    the program captures masked branches rather than IF nodes, under
    "restart" the Krylov restart."""
    from fvens_tpu_torch.cases.casesolvers import build_space
    from fvens_tpu_torch.solver import device_counts
    from fvens_tpu_torch.solver.device_stepping import (StepProgram,
                                                        no_host_sync)
    dev = comm.device
    cfg = case_config()
    md = cylinder_omesh(64, 32, stretch=1.15 ** (20.0 / 32))
    flow = ShardedFlow(build_space(cfg), partition_mesh(md, BCS, comm.size),
                       comm)
    be = DistributedBackwardEuler(space=flow.space, cfg=cfg.main,
                                  lin=cfg.linear, nl=cfg.nl_update,
                                  flow=flow)
    dm = flow.dist_mesh()
    lm, bl = dm.to(torch.float32), be._banded(dm)
    u0 = flow.initial_state()
    u = u0 * (1.0 + 0.01 * torch.from_numpy(np.random.default_rng(5)
                                            .standard_normal(tuple(u0.shape))
                                            ).to(dev))
    f = lambda x: torch.tensor(x, dtype=torch.float64, device=dev)
    out = {}
    device_counts.enable(dev)
    try:
        prog = StepProgram(be, dm, lm, bl, u)
        prog(u, 50.0, 1e-2, 1.0)        # the warm-up and the capture
        for cfl in (500.0, 2000.0):
            want = be._device_step(dm, u, f(cfl), f(1e-2), f(1.0), lmesh=lm,
                                   bl=bl)[:3]
            device_counts.zero()
            got = prog(u, cfl, 1e-2, 1.0)
            torch.cuda.synchronize()
            out[cfl] = (all(torch.equal(a, b) for a, b in zip(got, want)),
                        int(got[2]), float(got[1]), device_counts.read(dev))
    finally:
        device_counts.disable()
    from chip_smoke import captured_nodes
    out.update(graph=captured_nodes(dev, prog), masked=prog.program.masked,
               restart=be.lin.restart)
    try:
        with no_host_sync(dev):
            allreduce_sum(comm, torch.ones(91, device=dev))
        out["reduce_in_no_host_sync"] = True
    except RuntimeError:
        out["reduce_in_no_host_sync"] = False
    return out
