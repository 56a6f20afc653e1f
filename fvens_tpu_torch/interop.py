"""Hand the JAX package's arrays, as NumPy, to the port.

These take plain NumPy arrays (what np.asarray makes of the JAX package's
arrays) and build the port's tensors, so a test can feed both packages the
same mesh, state and Jacobian. Nothing here imports JAX. Like every
entry point of the port, they put their tensors on the card unless the
caller asks for the CPU (device="cpu").
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh.device_mesh import CompiledMesh
from .solver.linear import BlockJacobian


def mesh_from_numpy(fields: dict, dtype: torch.dtype = torch.float64,
                    device: torch.device | str = "cuda") -> CompiledMesh:
    """A CompiledMesh from a dict of every field (as arrays) and the
    metadata ints n_cells, n_bfaces, n_ifaces, NC, NF, n_colors."""
    return CompiledMesh.from_numpy(fields, dtype=dtype, device=device)


def state_from_numpy(u, dtype: torch.dtype | None = None,
                     device: torch.device | str = "cuda") -> torch.Tensor:
    """(NC, 4) state; dtype defaults to the array's own."""
    t = torch.from_numpy(np.array(u, copy=True))
    return t.to(dtype=dtype or t.dtype, device=device)


def jacobian_from_numpy(D, N, dtype: torch.dtype | None = None,
                        device: torch.device | str = "cuda") -> BlockJacobian:
    """BlockJacobian from diagonal blocks D (NC,4,4) and slot blocks
    N (NC,4,4,4)."""
    return BlockJacobian(D=state_from_numpy(D, dtype, device),
                         N=state_from_numpy(N, dtype, device))
