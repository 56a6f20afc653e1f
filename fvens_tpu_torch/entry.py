"""Entry points of the port: the forward step and the distributed dry run.

entry(): the twin of the JAX package's `__graft_entry__.entry()`: the flow
residual and local time steps of the flagship laminar NACA0012 case (M 0.5,
Re 5000, Roe, weighted least squares, LINEAR reconstruction, adiabatic wall
on marker 2, inflow/outflow on marker 4) on naca0012_omesh(96, 32), at f32,
on the CUDA card unless the caller passes device="cpu".

dryrun_multichip(n_devices): the twin of `__graft_entry__.
dryrun_multichip`: one full distributed explicit and implicit pseudo-time
step, the other distributed implicit forms and two converged mini-solves
over n_devices ranks (dist/launch.py, one process each) on a tiny
cylinder: real domain decomposition, neighbour halo exchange, reduced
residual norms. Where the JAX function takes a virtual CPU mesh when
fewer chips exist, the ranks here are:

  - device="cpu": gloo ranks on the host;
  - device="cuda" (the default): NCCL with one card per rank where
    n_devices cards are visible, else gloo ranks that all share cuda:0 and
    stage their messages through host memory (NCCL refuses two ranks on one
    card); a caller that names `backend` (and a device such as "cuda:0")
    gets exactly that. Without a card it raises: it never runs on the CPU
    unless asked.

    python -m fvens_tpu_torch.entry [--devices D] [--device cpu]

runs entry() and then dryrun_multichip(D) (D = 8 by default), as
`python __graft_entry__.py` does.
"""

from __future__ import annotations

import os
import time

import torch

from .cases.casesolvers import build_space, initial_state
from .config import BCSpec, FlowCaseConfig, NumericsConfig, PhysicsConfig
from .mesh.device_mesh import compile_mesh
from .mesh.meshgen import naca0012_omesh

# the dry run's process-group timeout and the bound on its whole run, s
DRYRUN_TIMEOUT = 600.0
DRYRUN_JOIN_TIMEOUT = 1800.0


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


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: str | None = None) -> dict:
    """The distributed dry run on `n_devices` ranks (the module docstring
    says which). Prints rank 0's line, the JAX function's word for word with
    the port's numbers ("exchange rounds" in place of "ppermute rounds"),
    then one line naming the ranks' backend and route; returns the same
    numbers at full precision as a dict (`line`, `explicit_res`, `steps`,
    `mini_solves` with each one's per-step history (step, residual, CFL,
    Krylov iterations), `halo`, `route`, `device`, `wall_s`, and
    `launches`, the CUDA kernels' launches summed over the ranks: the
    banded step's K1 on the card, none on the CPU). A residual that is not
    finite, a missing band analysis or a mini-solve that does not converge
    fails the run (RuntimeError in the rank), as the JAX function's
    asserts do."""
    from .dist import launch
    dev = torch.device(device)
    threads = 0
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device "
                               "(torch.cuda.is_available() is false); pass "
                               "device='cpu' to run on the CPU")
        if backend is None:
            if dev.index is None and torch.cuda.device_count() >= n_devices:
                backend = "nccl"
            else:
                backend = "gloo"
                if dev.index is None:
                    device = "cuda:0"
    else:
        threads = max(1, (os.cpu_count() or 1) // n_devices)
    t0 = time.perf_counter()
    ranks = launch.run(_dryrun_rank, n_devices, device=device,
                       backend=backend, timeout=DRYRUN_TIMEOUT,
                       join_timeout=DRYRUN_JOIN_TIMEOUT, threads=threads)
    out = ranks[0]
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = {k: sum(r["launches"][k] for r in ranks)
                       for k in out["launches"]}
    print(out["line"])
    print(f"dryrun_multichip({n_devices}): {n_devices} ranks "
          f"({out['route']}) on {out['device']}, {out['wall_s']:.1f} s")
    return out


def dryrun_case(n_devices: int) -> tuple:
    """(FlowFV, MeshData, bcs) of the dry run on n_devices parts: the JAX
    function's physics (M 0.38, viscous, HLLC, weighted least squares,
    LINEAR, adiabatic wall on marker 2, far field on marker 4) on
    cylinder_omesh(8 n_devices, 6), tiny but parted non-trivially."""
    from .fv.residual import FlowFV
    from .mesh.meshgen import cylinder_omesh
    from .physics.gas import GasPhysics
    pcfg = PhysicsConfig(Minf=0.38, viscous=True)
    ncfg = NumericsConfig(flux="HLLC", gradient="LEASTSQUARES",
                          reconstruction="LINEAR", order2=True)
    phy = GasPhysics(g=pcfg.gamma, Minf=pcfg.Minf, Tinf=pcfg.Tinf,
                     Reinf=pcfg.Reinf, Pr=pcfg.Pr)
    bcs = [BCSpec(marker=2, type="adiabaticwall", values=(0.0,)),
           BCSpec(marker=4, type="farfield")]
    return (FlowFV(phy=phy, pcfg=pcfg, ncfg=ncfg),
            cylinder_omesh(8 * n_devices, 6), bcs)


def _dryrun_rank(comm) -> dict:
    """One rank of dryrun_multichip (importable, for spawn): the JAX
    function's work on this rank's part; rank 0 returns the numbers."""
    from .config import (LinearSolverConfig, NonlinearUpdateConfig,
                         PseudoTimeConfig)
    from .dist import halo_schedule_stats, partition_mesh
    from .dist.shard import DistributedBackwardEuler, ShardedFlow

    n = comm.size
    space, md, bcs = dryrun_case(n)
    bundle = partition_mesh(md, bcs, n)
    sf = ShardedFlow(space, bundle, comm, dtype=torch.float32)

    def check(ok, what):
        if not ok:
            raise RuntimeError(f"dryrun_multichip: {what}")

    def finite(res, what):
        check(res == res, f"distributed {what} produced NaN")
        return res

    # explicit distributed step (halo exchange + reduced norm)
    _, resf = sf.fe_step(sf.initial_state(), 0.5)
    finite(resf, "explicit step")

    # the full implicit step: part-local Jacobian, halo-exchanged GMRES
    # matvec, part-local SGS, reduced inner products
    def lin(**kw):
        return LinearSolverConfig(restart=20, maxiter=20, rtol=1e-1,
                                  rtol_adapt=False, **kw)
    nl = NonlinearUpdateConfig(scheme="robust_flow")
    steps = {}
    _, res, it = sf.be_step(sf.initial_state(), 50.0, 0.1, lin=lin(), nl=nl)
    steps["implicit"] = dict(res=finite(res, "implicit step"),
                             krylov_iters=int(it))

    def solver(**kw):
        return DistributedBackwardEuler(space=space, cfg=PseudoTimeConfig(),
                                        lin=lin(**kw), nl=nl, flow=sf)
    dm = sf.dist_mesh()
    # matrix-free: the JVP through the halo exchange (the reference's
    # parallel MATSHELL) with the assembled part-local preconditioner
    _, res, it = solver(matrix_free=True)._step(dm, sf.initial_state(),
                                                50.0, 0.1)
    steps["matrix_free"] = dict(res=finite(res, "matrix-free step"),
                                krylov_iters=int(it))
    # banded: per-part band operators, seam and halo couplings in the rest
    # lists (on the card the banded-apply kernel)
    bd = solver(pc="bsgs", banded=True)
    blb = bd._banded(dm)
    check(blb is not None, "partitioned O-mesh must be band-dominant")
    _, res, it = bd._step(dm, sf.initial_state(), 50.0, 0.1, bl=blb)
    steps["banded"] = dict(res=finite(res, "banded step"),
                           krylov_iters=int(it))
    # GCRO-DR, harvesting its recycled space from a first solve
    _, res, it, _, U = solver(deflation_k=4)._step(
        dm, sf.initial_state(), 50.0, 0.1, defl=True, return_carry=True)
    check(res == res and bool(torch.isfinite(U).all()),
          "distributed deflated step produced NaN")
    steps["deflated"] = dict(res=res, krylov_iters=int(it))

    # converged mini-solves: the full host controller driving the
    # distributed step to a 1e-4 relative residual drop, with the default
    # pc and with per-part ILU0 (the reference's parallel bjacobi + ILU0)
    legs = {}
    for pc in ("bcsgs", "ilu0"):
        _, info = sf.solve_implicit(
            PseudoTimeConfig(cfl_init=25.0, cfl_fin=500.0, tol=1e-4,
                             maxiter=150),
            lin=LinearSolverConfig(restart=30, maxiter=30, rtol=1e-2, pc=pc,
                                   pc_sweeps=3 if pc == "ilu0" else 1),
            nl=nl)
        check(info.converged, f"distributed pc={pc} mini-solve diverged")
        legs[pc] = dict(steps=info.steps, lin_iters=info.total_lin_iters,
                        history=[[s, r, c, i]
                                 for s, _, r, c, i in info.history])
    # scheduled sends must equal the partition's halo (checked inside)
    hs = halo_schedule_stats(bundle, value_bytes=4)
    launches = kernel_launches()
    if comm.rank != 0:
        return dict(launches=launches)
    line = (
        f"dryrun_multichip({n}): ok, explicit res {resf:.3e}, "
        + ", ".join(
            f"{label}implicit res {steps[k]['res']:.3e} "
            f"({steps[k]['krylov_iters']} Krylov iters)"
            for k, label in (("implicit", ""),
                             ("matrix_free", "matrix-free "),
                             ("banded", "banded "),
                             ("deflated", "deflated ")))
        + ", "
        + ", ".join(
            f"mini-solve pc={pc} converged rel 1e-4 in {i['steps']} steps "
            f"({i['lin_iters']} lin iters)" for pc, i in legs.items())
        + f"; halo schedule: {hs['rounds']} exchange rounds, "
        f"{hs['messages_per_exchange']} messages/exchange, "
        f"{hs['halo_cells']} halo cells "
        f"({hs['bytes_per_exchange']} B/exchange) vs edge cut "
        f"{hs['cut_faces']} faces — scheduled sends == halo (asserted)")
    return dict(line=line, n_devices=n, explicit_res=resf, steps=steps,
                mini_solves=legs,
                halo={k: hs[k] for k in ("rounds", "messages_per_exchange",
                                         "halo_cells", "bytes_per_exchange",
                                         "cut_faces")},
                route=comm.route, device=str(comm.device),
                launches=launches)


def kernel_launches() -> dict:
    """This process's launches of the three CUDA kernels so far (each
    wrapper counts the launches of its kernel, never its twin's runs)."""
    from .solver import banded_kernels as bk
    from .solver import rowset_kernels as rk
    return {"banded_apply": bk.banded_apply.launches,
            "banded_bsgs": bk.bsgs_apply.launches,
            "row_set": rk.row_set.launches}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="the port's forward step, "
                                             "then its distributed dry run")
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the dry run (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:K (every rank on card K, "
                         "gloo) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        import sys
        print("fvens_tpu_torch: no CUDA device (torch.cuda.is_available() "
              "is false); pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1
    fn, fargs = entry(device=args.device)
    rhs, dt = fn(*fargs)
    if not bool(torch.isfinite(rhs).all() & torch.isfinite(dt).all()):
        raise RuntimeError("entry(): non-finite forward step")
    print("entry(): forward step ok")
    dryrun_multichip(args.devices, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
