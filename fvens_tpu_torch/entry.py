"""Forward-step entry point of the port.

entry(): the twin of the JAX package's `__graft_entry__.entry()`: the flow
residual and local time steps of the flagship laminar NACA0012 case (M 0.5,
Re 5000, Roe, weighted least squares, LINEAR reconstruction, adiabatic wall
on marker 2, inflow/outflow on marker 4) on naca0012_omesh(96, 32), at f32,
on the CUDA card unless the caller passes device="cpu".
"""

from __future__ import annotations

import torch

from .cases.casesolvers import build_space, initial_state
from .config import BCSpec, FlowCaseConfig, NumericsConfig, PhysicsConfig
from .mesh.device_mesh import compile_mesh
from .mesh.meshgen import naca0012_omesh


def entry(device: torch.device | str = "cuda",
          dtype: torch.dtype = torch.float32):
    """Returns (fn, example_args): fn(u) -> (rhs, dt), the forward step, and
    example_args the free-stream state (u0,)."""
    cfg = FlowCaseConfig(
        physics=PhysicsConfig(Minf=0.5, Reinf=5000.0, Tinf=288.15,
                              viscous=True),
        numerics=NumericsConfig(flux="ROE", gradient="LEASTSQUARES",
                                reconstruction="LINEAR", order2=True),
        bcs=[BCSpec(marker=2, type="adiabaticwall", values=(0.0,)),
             BCSpec(marker=4, type="inflowoutflow")],
    )
    mesh = compile_mesh(naca0012_omesh(96, 32), cfg.bcs, dtype=dtype,
                        device=device)
    space = build_space(cfg)
    u0 = initial_state(space, mesh)

    def fn(u):
        return space.compute_residual(mesh, u, True)

    return fn, (u0,)
