"""Physical-time integration: TVD Runge-Kutta 1/2/3 with a global time step.

Reference: FVENS src/ode/aodesolver.cpp:45-67 (coefficient table) and
:672-785 (stage loop with global minimum time step dt_min * CFL). Each step
reads its time step back to the host once, to advance t and test it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TVDRK_COEFFS = {
    1: [(1.0, 0.0, 1.0)],
    2: [(1.0, 0.0, 1.0), (0.5, 0.5, 0.5)],
    3: [(1.0, 0.0, 1.0), (0.75, 0.25, 0.25),
        (1.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0)],
}


@dataclasses.dataclass
class TVDRKSolver:
    space: object
    order: int = 3
    cfl: float = 0.5

    def _step(self, mesh, u, remaining: float):
        """One physical time step of `order` TVD-RK stages; dt from stage 1,
        clipped to `remaining` so the last step lands exactly on the
        requested final time (no O(dt) overshoot in time-accurate
        comparisons). Returns (u, dt) with dt a 0-d tensor."""
        coeffs = TVDRK_COEFFS[self.order]
        ustage = u
        dtg = None
        for istage, (a, b, c) in enumerate(coeffs):
            # signs: rhs is the NEGATIVE flux divergence, so the reference's
            # "- c*dt/vol * residual" with its rvec (= -r) becomes "+" here
            rhs, dt = self.space.compute_residual(mesh, ustage, True)
            if istage == 0:
                dtmin = torch.where(mesh.cell_mask > 0, dt, torch.inf).amin()
                dtg = torch.clamp_max(dtmin * self.cfl, remaining)
            ustage = (a * u + b * ustage
                      + (c * dtg * mesh.inv_area)[..., None] * rhs)
        return ustage, dtg

    def solve(self, mesh, u0, final_time: float):
        """(u, t, steps): march u0 to t = final_time."""
        u = u0
        t = 0.0
        nsteps = 0
        while t < final_time - 1e-12:
            u, dt = self._step(mesh, u, final_time - t)
            dtf = dt.item()
            if not np.isfinite(dtf):
                raise ArithmeticError("TVDRK diverged: dt NaN/inf")
            t += dtf
            nsteps += 1
        return u, t, nsteps
