"""Preconditioner sweep benchmark harness.

The port's twin of the JAX package's cases/perftest.py, itself the
equivalent of the reference's threads_async perftest (FVENS
perftest/threads_async.cpp:5-18, threads_async_tests.cpp:102-330): sweep the
preconditioner configuration grid (kind x sweep counts x Krylov budget),
repeat each solve, and report averaged wall times and iteration counts.
A solve that fails stops the sweep with its exception.

Usage: python -m fvens_tpu_torch.cases.perftest case.ctrl [--mesh_file m.msh]
           [--repeats 3] [--f32] [--device cuda|cpu] [--breakdown]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

# (pc, pc_sweeps, Krylov budget): the JAX package's grid
GRID = (("bjacobi", 0, 60), ("bsgs", 2, 60), ("bsgs", 4, 60),
        ("bcsgs", 1, 30), ("bcsgs", 1, 60), ("bcsgs", 2, 60),
        ("bcsgs", 4, 60))


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("control_file")
    ap.add_argument("--mesh_file", default=None)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--breakdown", action="store_true",
                    help="time the implicit-step kernels separately "
                         "(residual / Jacobian / pc apply / matvec), the "
                         "reference TimingData's per-component view")
    args = ap.parse_args(argv)

    import torch

    from ..config import LinearSolverConfig
    from ..io_config import parse_control_file
    from .casesolvers import SteadyFlowCase, load_case_mesh

    if args.device == "cuda" and not torch.cuda.is_available():
        print("perftest: no CUDA device; pass --device cpu", file=sys.stderr)
        return 1
    cfg0 = parse_control_file(args.control_file, mesh_file=args.mesh_file)
    dtype = torch.float32 if args.f32 else torch.float64
    mesh = load_case_mesh(cfg0, dtype=dtype, device=args.device)

    if args.breakdown:
        return kernel_breakdown(cfg0, mesh, args.repeats)

    results = []
    for pc, sweeps, kmax in GRID:
        cfg = dataclasses.replace(cfg0, linear=LinearSolverConfig(
            restart=kmax, maxiter=kmax, rtol=1e-1, pc=pc, pc_sweeps=sweeps))
        case = SteadyFlowCase(cfg)
        walls, steps, its = [], [], []
        for _ in range(args.repeats):
            _sync(mesh.device)
            t0 = time.perf_counter()
            u, info, _ = case.run_output(mesh)
            _sync(mesh.device)
            walls.append(time.perf_counter() - t0)
            steps.append(info.steps)
            its.append(info.total_lin_iters)
        rec = {"pc": pc, "sweeps": sweeps, "krylov": kmax,
               "avg_wall_s": sum(walls) / len(walls),
               "min_wall_s": min(walls),
               "steps": steps[0], "total_lin_iters": its[0]}
        results.append(rec)
        print(json.dumps(rec), flush=True)

    best = min(results, key=lambda r: r["min_wall_s"])
    print("# best:", json.dumps(best))
    return 0


def kernel_breakdown(cfg, mesh, repeats: int = 3) -> int:
    """Per-kernel timing of the implicit-step components (the reference's
    TimingData records the linear-solve walltime and apply counts,
    aodesolver.hpp:46-67). Each component is called once to warm up, then
    timed over max(repeats, 3) calls: with CUDA events on the card, on the
    host clock on the CPU. Prints one JSONL record per kernel:
    {"kernel": ..., "ms": ...}."""
    import torch

    from ..solver import jacobian as jacmod
    from ..solver.linear import make_bsr_matvec, make_preconditioner
    from .casesolvers import build_space, initial_state

    space = build_space(cfg)
    u = initial_state(space, mesh)

    rhs, dt = space.compute_residual(mesh, u, True)
    jac = space.assemble_jacobian(mesh, u)
    jac = jacmod.add_pseudotime_term(mesh, jac, 100.0, dt)
    pc = make_preconditioner(mesh, jac, cfg.linear.pc, cfg.linear.pc_sweeps)
    mv = make_bsr_matvec(mesh, jac)

    kernels = {
        "residual": (lambda v: space.compute_residual(mesh, v, True)[0], u),
        "jacobian_assembly": (lambda v: space.assemble_jacobian(mesh, v).D,
                              u),
        "pc_apply": (pc, rhs),
        "bsr_matvec": (mv, rhs),
    }
    cuda = mesh.device.type == "cuda"
    n = max(repeats, 3)
    for name, (fn, a) in kernels.items():
        fn(a)
        _sync(mesh.device)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn(a)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / n
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                fn(a)
            ms = (time.perf_counter() - t0) / n * 1e3
        print(json.dumps({"kernel": name, "ms": ms,
                          "cells": mesh.n_cells}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
