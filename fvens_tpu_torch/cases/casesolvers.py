"""Flow cases (the reference's case API, FVENS
src/utilities/casesolvers.cpp): the spatial discretization from a case
config, the free-stream initial state, the case mesh from its file;
SteadyFlowCase: the first-order low-tolerance STARTER solve (:225-314,
tolerance failures swallowed) followed by the second-order MAIN solve
(:316-386), each implicit or explicit as its PseudoTimeConfig says, with
checkpoints and functionals logged during an implicit main solve, and the
output functionals (entropy error, CL, CDp, CDsf) of the result; and
UnsteadyFlowCase: TVD-RK physical-time integration to the final time
(:420-447).
"""

from __future__ import annotations

import dataclasses

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
