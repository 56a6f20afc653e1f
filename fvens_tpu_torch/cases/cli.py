"""fvens_steady-equivalent CLI of the PyTorch port.

Usage:  python -m fvens_tpu_torch.cases.cli case.ctrl [--mesh_file m.msh]
            [-options_file opts.solverc] [--device cuda|cpu] [--f32]
            [--vtu out.vtu] [--surface s.dat] [--volume v.dat]
            [--history h.jsonl] [--checkpoint ck.npz] [--devices N]

The twin of the JAX package's cases/cli.py, mirroring the reference's
fvens_steady program (FVENS src/fvens_steady.cpp:15-57): parse the control
file (and the PETSc options file), read the mesh, free-stream init,
starter + main solve (implicit or explicit pseudo-time), or for an unsteady
control file TVD-RK stepping to its final time, then write functionals,
surface data, the volume table and VTU output. It runs on the CUDA card
unless `--device cpu` is given; there is no fallback from one to the other.

`--devices N` runs the steady case domain-decomposed over N ranks
(casesolvers.DistributedFlowCase, the reference's `mpirun -n N`), one
process each (dist/launch.py): on the card NCCL with one card per rank
(fewer than N cards visible: a one-line error and exit 1, never a shared
card or another backend), with `--device cpu` gloo. Rank 0 prints and
writes every output; the main solve's checkpoint holds the stacked
per-part state. As in the JAX package, an unsteady control file runs on
one device whatever --devices says.

Refused with NotImplementedError: `--pipeline` (pipelined stepping is
ported only once an H100 measurement shows the per-step host sync costs
time), and `--functionals_every` with `--devices` (the functionals of a
distributed run are evaluated once, on the gathered state).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="fvens_tpu_torch steady flow "
                                             "solver")
    ap.add_argument("control_file")
    ap.add_argument("--mesh_file", default=None,
                    help="override the control file's mesh")
    ap.add_argument("-options_file", "--options_file", default=None,
                    help="PETSc-style .solverc options file (the reference's "
                         "-options_file flag): ksp/pc settings are mapped "
                         "onto the port's linear solver as in the JAX "
                         "package")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the CUDA card (default) or the CPU")
    ap.add_argument("--f32", action="store_true",
                    help="solve in float32")
    ap.add_argument("--vtu", default=None, help="write VTU solution here")
    ap.add_argument("--surface", default=None,
                    help="write wall surface data (x y Cp Cf) here")
    ap.add_argument("--volume", default=None,
                    help="write volume data (x y rho vx vy p T Mach) here")
    ap.add_argument("--history", default=None,
                    help="write convergence history (JSONL) here")
    ap.add_argument("--functionals_every", type=int, default=0,
                    help="log the functionals (entropy/CL/CDp/CDsf), "
                         "evaluated on the device, to the history every N "
                         "steps (0 = off)")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint/resume the main solve at this path")
    ap.add_argument("--mesh_reorder", default="none",
                    choices=["none", "rcm", "line", "line_rcm"],
                    help="cell reordering (reference -mesh_reorder)")
    ap.add_argument("--mesh_anisotropy_threshold", type=float, default=None,
                    help="minimum local grid anisotropy for a cell to join "
                         "a line under line orderings (reference "
                         "-mesh_anisotropy_threshold, doc/user-doc.md:22; "
                         "default 10.0)")
    ap.add_argument("--devices", type=int, default=0,
                    help="run domain-decomposed over N ranks (the "
                         "reference's mpirun -n N; 0 = one device): NCCL "
                         "with one card per rank, or gloo with --device cpu")
    ap.add_argument("--pipeline", action="store_true",
                    help="software-pipelined host stepping (not ported)")
    ap.add_argument("--log_every", type=int, default=10)
    return ap.parse_args(argv)


# the process group's timeout of a --devices run, s: the longest a rank
# waits in one collective (rank 0 writes the outputs while the others wait)
DEVICES_TIMEOUT = 1800.0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.pipeline:
        raise NotImplementedError(
            "not ported: pipelined host stepping (--pipeline); it is ported "
            "only once an H100 measurement shows the per-step host sync "
            "costs time (ROADMAP)")
    if args.devices and args.functionals_every:
        raise NotImplementedError(
            "--functionals_every has no distributed form: a --devices run "
            "evaluates the functionals once, on the gathered state")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("fvens_tpu_torch: no CUDA device (torch.cuda.is_available() "
              "is false); pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1
    if not args.devices:
        return _run(args)
    if args.device == "cuda" and torch.cuda.device_count() < args.devices:
        print(f"fvens_tpu_torch: --devices {args.devices} needs "
              f"{args.devices} CUDA cards (one per NCCL rank); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    from ..dist import launch
    cpu = args.device == "cpu"
    return launch.run(
        _cli_rank, args.devices, args=(args,), device=args.device,
        timeout=DEVICES_TIMEOUT,
        threads=max(1, (os.cpu_count() or 1) // args.devices) if cpu
        else 0)[0]


def _cli_rank(comm, args) -> int:
    """A rank of a --devices run (importable, for spawn)."""
    return _run(args, comm)


def _run(args, comm=None) -> int:
    """The CLI's work after its checks, on one device or (with `comm`) as
    one rank of a distributed run, whose rank 0 prints and writes."""
    import numpy as np
    import torch

    from ..io_config import parse_control_file, write_vtu
    from ..io_config.logs import ConvergenceLogger
    from ..mesh.device_mesh import compile_mesh
    from ..mesh.reader import read_mesh
    from ..output import (cell_fields, surface_data, volume_data,
                          write_surface_table)
    from .casesolvers import (DistributedFlowCase, SteadyFlowCase,
                              UnsteadyFlowCase, build_space)

    lead = comm is None or comm.rank == 0
    say = print if lead else (lambda *a, **k: None)
    device = args.device if comm is None else comm.device
    cfg = parse_control_file(args.control_file, mesh_file=args.mesh_file)
    if args.options_file:
        from ..io_config.solverc import load_solver_options
        lin, reorder, aniso = load_solver_options(
            args.options_file, base=cfg.linear,
            warn=lambda m: say(f"fvens_tpu_torch: {m}"))
        cfg = dataclasses.replace(cfg, linear=lin)
        if args.mesh_reorder == "none" and reorder:
            args.mesh_reorder = reorder
        if args.mesh_anisotropy_threshold is None and aniso is not None:
            args.mesh_anisotropy_threshold = aniso
        say(f"fvens_tpu_torch: solver options from {args.options_file}: "
            f"pc={lin.pc}, restart={lin.restart}, maxiter={lin.maxiter}, "
            f"rtol={lin.rtol}" + (f", reorder={reorder}" if reorder else ""))
    if args.checkpoint:
        cfg = dataclasses.replace(cfg, checkpoint_path=args.checkpoint)
    if args.functionals_every:
        cfg = dataclasses.replace(cfg,
                                  functionals_every=args.functionals_every)
    dtype = torch.float32 if args.f32 else torch.float64

    if not os.path.exists(cfg.mesh_file):
        print(f"fvens_tpu_torch: mesh file not found: {cfg.mesh_file}",
              file=sys.stderr)
        return 1
    md = read_mesh(cfg.mesh_file)
    if args.mesh_reorder != "none":
        from ..mesh.ordering import apply_ordering
        md = apply_ordering(md, args.mesh_reorder,
                            anisotropy_threshold=(
                                args.mesh_anisotropy_threshold
                                if args.mesh_anisotropy_threshold is not None
                                else 10.0))
    mesh = None             # rank 0 alone needs the whole mesh (outputs)
    if lead:
        mesh = compile_mesh(md, cfg.bcs, dtype=dtype, device=device)
        print(f"fvens_tpu_torch: mesh {cfg.mesh_file}: {mesh.n_cells} "
              f"cells, {mesh.n_bfaces} boundary faces, {mesh.n_faces} faces"
              + (f"; {comm.size} ranks ({comm.route})" if comm else ""))

    # live step monitor (+ streamed JSONL history if --history given):
    # SteadyStepMonitor / log_file_prefix parity (aodesolver.cpp:541-558)
    logger = (ConvergenceLogger(path=args.history,
                                print_every=args.log_every, label="main")
              if lead else None)
    t0 = time.perf_counter()
    try:
        if cfg.sim_type == "unsteady":
            if not lead:
                return 0
            # ctrl-driven physical-time run (reference casesolvers.cpp:
            # 424-444); writes the state at final_time
            u, info, fnls = UnsteadyFlowCase(cfg).run_output(mesh)
            print(f"fvens_tpu_torch: unsteady TVDRK{cfg.time_order} to "
                  f"t={cfg.final_time} in {info.steps} steps")
        elif comm is not None:
            case = DistributedFlowCase(cfg, n_devices=comm.size,
                                       dtype=dtype)
            u, info, fnls = case.rank_run_output(
                comm, md, log_every=args.log_every, logger=logger, mesh=mesh)
            if not lead:
                return 0
        else:
            case = SteadyFlowCase(cfg)
            u, info, fnls = case.run_output(mesh, log_every=args.log_every,
                                            logger=logger)
    finally:
        if logger is not None:
            logger.close()
    wall = time.perf_counter() - t0

    print(f"fvens_tpu_torch: solved in {info.steps} steps, "
          f"{info.total_lin_iters} linear iterations, {wall:.3f} s")
    print(f"  entropy error: {fnls.entropy:.10e}")
    print(f"  CL   = {fnls.CL:.15e}")
    print(f"  CDp  = {fnls.CDp:.15e}")
    print(f"  CDsf = {fnls.CDsf:.15e}")

    space = build_space(cfg)
    if args.surface and cfg.wall_markers:
        table, _ = surface_data(space, mesh, u, cfg.wall_markers)
        write_surface_table(args.surface, table)
        print(f"  wrote surface data to {args.surface}")

    if args.volume:
        np.savetxt(args.volume, volume_data(space, mesh, u),
                   header="x y rho vx vy p T mach")
        print(f"  wrote volume data to {args.volume}")

    if args.vtu:
        f = cell_fields(space, mesh, u)
        write_vtu(args.vtu, md,
                  cell_scalars={"density": f["u"][:, 0], "pressure": f["p"],
                                "mach": f["mach"]},
                  cell_vectors={"velocity": f["v"]})
        print(f"  wrote VTU solution to {args.vtu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
