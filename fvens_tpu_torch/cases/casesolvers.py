"""Flow cases (the reference's case API, FVENS
src/utilities/casesolvers.cpp): the spatial discretization from a case
config, the free-stream initial state, the case mesh from its file;
SteadyFlowCase: the first-order low-tolerance STARTER solve (:225-314,
tolerance failures swallowed) followed by the second-order MAIN solve
(:316-386), each implicit or explicit as its PseudoTimeConfig says, with
checkpoints and functionals logged during an implicit main solve, and the
output functionals (entropy error, CL, CDp, CDsf) of the result;
UnsteadyFlowCase: TVD-RK physical-time integration to the final time
(:420-447); and DistributedFlowCase: the steady case domain-decomposed
over ranks (the reference's `mpirun -n D fvens_steady`).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..config import FlowCaseConfig
from ..fv.residual import FlowFV
from ..mesh.device_mesh import CompiledMesh, compile_mesh
from ..mesh.reader import read_mesh
from ..output import (FlowSolutionFunctionals, entropy_error,
                      make_functionals, surface_data)
from ..physics.gas import GasPhysics
from ..solver.steady import (SolveInfo, SteadyBackwardEuler,
                             SteadyForwardEuler, ToleranceError)
from ..solver.unsteady import TVDRKSolver


def build_space(cfg: FlowCaseConfig, order2: bool | None = None) -> FlowFV:
    p = cfg.physics
    phy = GasPhysics(g=p.gamma, Minf=p.Minf, Tinf=p.Tinf, Reinf=p.Reinf,
                     Pr=p.Pr)
    ncfg = cfg.numerics
    if order2 is not None and order2 != ncfg.order2:
        ncfg = dataclasses.replace(ncfg, order2=order2)
    if not ncfg.order2:
        # the starter forces first order: no gradients, no reconstruction
        # (controlparser.cpp:234-246 firstorder_spatial_numerics_config)
        ncfg = dataclasses.replace(ncfg, gradient="NONE",
                                   reconstruction="NONE")
    return FlowFV(phy=phy, pcfg=p, ncfg=ncfg)


def initial_state(space: FlowFV, mesh: CompiledMesh) -> torch.Tensor:
    """Uniform free-stream initialization (casesolvers.cpp:52-69), in the
    mesh's dtype on the mesh's device."""
    return space.uinf(mesh.dtype, mesh.device).repeat(mesh.NC, 1)


def load_case_mesh(cfg: FlowCaseConfig, mesh_file: str | None = None,
                   dtype: torch.dtype = torch.float64,
                   device: torch.device | str = "cuda") -> CompiledMesh:
    """The case's mesh file (or `mesh_file`) compiled with its BCs."""
    md = read_mesh(mesh_file or cfg.mesh_file)
    return compile_mesh(md, cfg.bcs, dtype=dtype, device=device)


@dataclasses.dataclass
class SteadyFlowCase:
    """Starter (first-order, loose tol) -> main (second-order) solve."""
    cfg: FlowCaseConfig
    # the last starter solve's SolveInfo (None before one ran)
    starter_info: SolveInfo | None = dataclasses.field(default=None,
                                                       init=False)

    def _make_solver(self, space, pt, checkpoint: bool = False):
        """The solver of one phase: SteadyForwardEuler for explicit
        stepping, else SteadyBackwardEuler, whose main phase (`checkpoint`)
        takes the case's checkpoint file and, with functionals_every and
        wall markers, the functional evaluator."""
        if pt.stepping == "explicit":
            return SteadyForwardEuler(space, pt)
        fn = None
        if checkpoint and self.cfg.functionals_every and self.cfg.wall_markers:
            fn = make_functionals(space, self.cfg.wall_markers)
        return SteadyBackwardEuler(
            space, pt, self.cfg.linear, self.cfg.nl_update,
            checkpoint_path=(self.cfg.checkpoint_path or None) if checkpoint
            else None,
            checkpoint_every=self.cfg.checkpoint_every,
            functional_fn=fn,
            functional_every=self.cfg.functionals_every)

    def execute_starter(self, mesh, u, log_every: int = 0):
        """First-order startup; tolerance failures are swallowed
        (casesolvers.cpp:294-299), and the state is then the one the
        starter began from, as in the JAX package. The starter's SolveInfo
        is kept as `starter_info`."""
        solver = getattr(self, "_starter_solver", None)
        if solver is None:
            solver = self._starter_solver = self._make_solver(
                build_space(self.cfg, order2=False), self.cfg.init)
        try:
            u, self.starter_info = solver.solve(mesh, u, log_every=log_every)
        except ToleranceError as e:
            self.starter_info = e.info
        return u

    def execute_main(self, mesh, u, log_every: int = 0, logger=None) -> tuple:
        solver = getattr(self, "_main_solver", None)
        if solver is None:
            solver = self._main_solver = self._make_solver(
                build_space(self.cfg), self.cfg.main, checkpoint=True)
        return solver.solve(mesh, u, log_every=log_every, logger=logger)

    def solve(self, mesh, u=None, log_every: int = 0, logger=None) -> tuple:
        """(u, SolveInfo of the main solve) from `u` (default: free
        stream)."""
        if u is None:
            u = initial_state(build_space(self.cfg), mesh)
        self.starter_info = None
        if self.cfg.use_starter and self.cfg.numerics.order2:
            u = self.execute_starter(mesh, u, log_every=log_every)
        return self.execute_main(mesh, u, log_every=log_every, logger=logger)

    def run_output(self, mesh, u=None, log_every: int = 0, logger=None
                   ) -> tuple[torch.Tensor, SolveInfo, FlowSolutionFunctionals]:
        """Solve and compute output functionals (casesolvers.cpp:75-164)."""
        u, info = self.solve(mesh, u, log_every=log_every, logger=logger)
        space = build_space(self.cfg)
        ent = entropy_error(space, mesh, u)
        CL = CDp = CDsf = 0.0
        if self.cfg.wall_markers:
            _, (CL, CDp, CDsf) = surface_data(space, mesh, u,
                                              self.cfg.wall_markers)
        return u, info, FlowSolutionFunctionals(mesh_size=mesh.h_param,
                                                entropy=ent, CL=CL, CDp=CDp,
                                                CDsf=CDsf)


@dataclasses.dataclass
class UnsteadyFlowCase:
    """Physical-time integration case (reference UnsteadyFlowCase,
    casesolvers.cpp:420-447: TVDRK is the only integrator implemented).
    Free-stream init, TVD-RK stages to cfg.final_time."""
    cfg: FlowCaseConfig

    def solve(self, mesh, u=None) -> tuple:
        """(u, t, steps) from `u` (default: free stream)."""
        if self.cfg.time_integrator != "TVDRK":
            raise ValueError(
                f"unknown time integrator '{self.cfg.time_integrator}'; "
                "only TVDRK is implemented (as in the reference)")
        space = build_space(self.cfg)
        if u is None:
            u = initial_state(space, mesh)
        solver = TVDRKSolver(space, order=self.cfg.time_order,
                             cfl=self.cfg.phy_cfl)
        return solver.solve(mesh, u, self.cfg.final_time)

    def run_output(self, mesh, u=None
                   ) -> tuple[torch.Tensor, SolveInfo, FlowSolutionFunctionals]:
        u, t, nsteps = self.solve(mesh, u)
        space = build_space(self.cfg)
        info = SolveInfo(converged=True, steps=nsteps)
        ent = entropy_error(space, mesh, u)
        CL = CDp = CDsf = 0.0
        if self.cfg.wall_markers:
            _, (CL, CDp, CDsf) = surface_data(space, mesh, u,
                                              self.cfg.wall_markers)
        return u, info, FlowSolutionFunctionals(mesh_size=mesh.h_param,
                                                entropy=ent, CL=CL, CDp=CDp,
                                                CDsf=CDsf)


# the process group's timeout of DistributedFlowCase.run_output's ranks, s:
# the longest a rank waits in one collective
DIST_TIMEOUT = 600.0


@dataclasses.dataclass
class DistributedFlowCase:
    """The steady case over D ranks: partition -> starter + main solve over
    the ranks -> gather (the JAX package's DistributedFlowCase).

    Role of the reference's `mpirun -n D fvens_steady` parallel runs
    (tests/inv-2dcyl/CMakeLists.txt:31-37): the mesh is domain-decomposed
    (dist/partition.py), each rank runs the implicit pseudo-time steps on
    its part with halo exchanges inside the residual and the matvec and
    reduced inner products in GMRES (dist/shard.py). As in the JAX
    package, the starter runs implicit whatever its ctrl says; the main
    solve takes the case's checkpoint file (rank 0 writes the stacked
    state, every rank reads its slab back), and the functionals are
    evaluated on the gathered state on rank 0.

    run_output starts the ranks itself (dist/launch.py): `device` "cuda"
    puts rank r on cuda:r over NCCL, "cpu" the ranks on the host over
    gloo, one torch thread each. Inside a rank, rank_run_output does the
    same work for that rank.
    """
    cfg: FlowCaseConfig
    n_devices: int = 1
    device: str = "cuda"
    dtype: torch.dtype = torch.float64

    def rank_solve(self, comm, md, log_every: int = 0, logger=None,
                   part=None) -> tuple:
        """This rank's solve: (ShardedFlow, its final slab, the main solve's
        SolveInfo). The ShardedFlow is kept as `flow`, the starter's
        SolveInfo and final slab as `starter_info` and `starter_u` (None
        without a starter), the host seconds of the set-up (partition and
        the part's mesh), the starter and the main solve as `times`.
        `part`: a given partition (the global part of every cell)."""
        from ..dist.partition import partition_mesh
        from ..dist.shard import ShardedFlow
        cfg = self.cfg
        if comm.rank != 0:
            log_every, logger = 0, None
        t0 = time.perf_counter()
        bundle = partition_mesh(md, cfg.bcs, comm.size, part=part)
        flow = self.flow = ShardedFlow(build_space(cfg), bundle, comm,
                                       self.dtype)
        u = flow.initial_state()
        t1 = time.perf_counter()
        self.starter_info = self.starter_u = None
        if cfg.use_starter and cfg.numerics.order2:
            sf1 = ShardedFlow(build_space(cfg, order2=False), bundle, comm,
                              self.dtype, said=flow.said)
            try:
                u, self.starter_info = sf1.solve_implicit(
                    cfg.init, lin=cfg.linear, nl=cfg.nl_update, u=u,
                    log_every=log_every)
            except ToleranceError as e:
                # swallowed, as in SteadyFlowCase (casesolvers.cpp:294-299)
                self.starter_info = e.info
            self.starter_u = u
        t2 = time.perf_counter()
        u, info = flow.solve_implicit(
            cfg.main, lin=cfg.linear, nl=cfg.nl_update, u=u,
            log_every=log_every, logger=logger,
            checkpoint_path=cfg.checkpoint_path or None,
            checkpoint_every=cfg.checkpoint_every)
        self.times = dict(setup_s=t1 - t0, starter_s=t2 - t1,
                          main_s=time.perf_counter() - t2)
        return flow, u, info

    def rank_run_output(self, comm, md, log_every: int = 0, logger=None,
                        mesh=None, part=None) -> tuple:
        """This rank's solve (rank_solve), then the output functionals of
        the gathered state: (u, SolveInfo, FlowSolutionFunctionals) on rank
        0, with u the global state padded to the compiled mesh (`mesh`,
        else md compiled on rank 0's device); (None, SolveInfo, None) on
        the others."""
        flow, u, info = self.rank_solve(comm, md, log_every, logger, part)
        ug = flow.gather_solution(u)
        if comm.rank != 0:
            return None, info, None
        if mesh is None:
            mesh = compile_mesh(md, self.cfg.bcs, dtype=self.dtype,
                                device=comm.device)
        space = build_space(self.cfg)
        u = initial_state(space, mesh)
        u[:mesh.n_cells] = torch.as_tensor(ug, dtype=mesh.dtype,
                                           device=mesh.device)
        ent = entropy_error(space, mesh, u)
        CL = CDp = CDsf = 0.0
        if self.cfg.wall_markers:
            _, (CL, CDp, CDsf) = surface_data(space, mesh, u,
                                              self.cfg.wall_markers)
        return u, info, FlowSolutionFunctionals(mesh_size=mesh.h_param,
                                                entropy=ent, CL=CL, CDp=CDp,
                                                CDsf=CDsf)

    def run_output(self, md, log_every: int = 0) -> tuple:
        """Start the ranks, solve, and return rank 0's (u as a NumPy array,
        SolveInfo of the main solve, FlowSolutionFunctionals); the
        starter's SolveInfo is kept as `starter_info`."""
        from ..dist import launch
        cpu = torch.device(self.device).type == "cpu"
        u, info, fnls, self.starter_info = launch.run(
            _run_output_rank, self.n_devices, args=(self, md, log_every),
            device=self.device, timeout=DIST_TIMEOUT,
            threads=1 if cpu else 0)[0]
        return u, info, fnls


def _run_output_rank(comm, case, md, log_every):
    """A rank of DistributedFlowCase.run_output (importable, for spawn)."""
    u, info, fnls = case.rank_run_output(comm, md, log_every)
    return (None if u is None else u.cpu().numpy(), info, fnls,
            case.starter_info)
