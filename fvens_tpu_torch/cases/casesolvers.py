"""Steady flow cases (the reference's case API,
FVENS src/utilities/casesolvers.cpp): the spatial discretization from a case
config, the free-stream initial state, and SteadyFlowCase: the first-order
low-tolerance STARTER solve (:225-314, tolerance failures swallowed)
followed by the second-order MAIN solve (:316-386), and the entropy error of
the result.

Explicit pseudo-time stepping, checkpointing, device-evaluated functionals
and the surface output (CL, CDp, CDsf) are still to be ported and raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import FlowCaseConfig
from ..fv.residual import FlowFV
from ..mesh.device_mesh import CompiledMesh
from ..output import FlowSolutionFunctionals, entropy_error
from ..physics.gas import GasPhysics
from ..solver.steady import SolveInfo, SteadyBackwardEuler, ToleranceError


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


@dataclasses.dataclass
class SteadyFlowCase:
    """Starter (first-order, loose tol) -> main (second-order) solve."""
    cfg: FlowCaseConfig
    # the last starter solve's SolveInfo (None before one ran)
    starter_info: SolveInfo | None = dataclasses.field(default=None,
                                                       init=False)

    def _make_solver(self, space, pt, checkpoint: bool = False):
        if pt.stepping == "explicit":
            raise NotImplementedError(
                "not ported yet: explicit pseudo-time stepping "
                "(SteadyForwardEuler)")
        if checkpoint and self.cfg.functionals_every and self.cfg.wall_markers:
            raise NotImplementedError(
                "not ported yet: functionals logged during the solve")
        return SteadyBackwardEuler(
            space, pt, self.cfg.linear, self.cfg.nl_update,
            checkpoint_path=(self.cfg.checkpoint_path or None) if checkpoint
            else None)

    def execute_starter(self, mesh, u):
        """First-order startup; tolerance failures are swallowed
        (casesolvers.cpp:294-299), and the state is then the one the
        starter began from, as in the JAX package. The starter's SolveInfo
        is kept as `starter_info`."""
        solver = getattr(self, "_starter_solver", None)
        if solver is None:
            solver = self._starter_solver = self._make_solver(
                build_space(self.cfg, order2=False), self.cfg.init)
        try:
            u, self.starter_info = solver.solve(mesh, u)
        except ToleranceError as e:
            self.starter_info = e.info
        return u

    def execute_main(self, mesh, u) -> tuple:
        solver = getattr(self, "_main_solver", None)
        if solver is None:
            solver = self._main_solver = self._make_solver(
                build_space(self.cfg), self.cfg.main, checkpoint=True)
        return solver.solve(mesh, u)

    def solve(self, mesh, u=None) -> tuple:
        """(u, SolveInfo of the main solve) from `u` (default: free
        stream)."""
        if u is None:
            u = initial_state(build_space(self.cfg), mesh)
        self.starter_info = None
        if self.cfg.use_starter and self.cfg.numerics.order2:
            u = self.execute_starter(mesh, u)
        return self.execute_main(mesh, u)

    def run_output(self, mesh, u=None
                   ) -> tuple[torch.Tensor, SolveInfo, FlowSolutionFunctionals]:
        """Solve and compute the entropy error (casesolvers.cpp:75-164)."""
        if self.cfg.wall_markers:
            raise NotImplementedError(
                "not ported yet: surface data and force coefficients "
                "(wall_markers)")
        u, info = self.solve(mesh, u)
        ent = entropy_error(build_space(self.cfg), mesh, u)
        return u, info, FlowSolutionFunctionals(mesh_size=mesh.h_param,
                                                entropy=ent)
