"""Output functionals: the entropy-production error.

PyTorch port of the JAX package's output.py (reference FVENS
src/spatial/aoutput.cpp:28-62). Surface data and the force coefficients
(CL, CDp, CDsf) are still to be ported.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class FlowSolutionFunctionals:
    """(ref casesolvers.hpp FlowSolutionFunctionals)"""
    mesh_size: float = 0.0
    entropy: float = 0.0
    CL: float = 0.0
    CDp: float = 0.0
    CDsf: float = 0.0


def entropy_error(space, mesh, u: torch.Tensor) -> float:
    """L2 norm of relative entropy production vs free stream
    (aoutput.cpp:28-62): sqrt( sum ((s-s_inf)/s_inf)^2 * area )."""
    phy = space.phy
    sinf = phy.entropy(space.uinf(u.dtype, u.device))
    serr = (phy.entropy(u) - sinf) / sinf
    return float(torch.sqrt((serr * serr * mesh.area * mesh.cell_mask).sum()))
