"""PETSc-style options-file (.solverc) reader: a copy of the JAX package's
io_config/solverc.py. Its mapping was chosen for that package on the TPU
and is kept as it is, so a .solverc means the same in both packages; an
option that maps to a preconditioner or operator the port does not have
(gamg -> amg, matrix-free) reaches the solver, which refuses it.

The reference drives its linear solver through the PETSc options database:
`fvens_steady case.ctrl -options_file opts.solverc`
(FVENS doc/user-doc.md:17-25, testcases/defaults.solverc). Every shipped
test case carries a .solverc next to its .ctrl; consuming it means the
reference cases run with their INTENDED solver settings, not this repo's
defaults.

Mapping policy: PETSc/BLASTed names are translated to the TPU-native
equivalent CLASS of each setting (measured equivalents, docs/BENCH_NOTES.md),
not emulated verbatim:

  -ksp_type fgmres          -> the (only) Krylov method, FGMRES
  -ksp_rtol R               -> LinearSolverConfig.rtol = R, rtol_adapt off
                               (PETSc tolerance is fixed, not Eisenstat-
                               Walker adapted)
  -ksp_max_it N             -> maxiter = N
  -ksp_gmres_restart M      -> restart = M (PETSc default 30)
  -pc_type bjacobi + -sub_pc_type ilu   -> pc='bsgs' sweeps 6 (the measured
                               TPU equivalent of bjacobi+ILU0 strength)
  -sub_pc_type sor          -> pc='bcsgs' (multicolor symmetric GS)
  -blasted_pc_type sgs/ilu0 -> bcsgs / bsgs likewise
  -pc_type gamg (+ -pc_mg_levels L, -mg_levels_ksp_max_it nu,
    -mg_coarse_ksp_max_it nc)           -> pc='amg' aggregation multigrid
                               (mg_levels = L-1 coarsening steps: PETSc
                               counts total levels including the fine one)
  -mesh_reorder rcm|line|line_rcm       -> returned for the mesh pipeline
  -mesh_anisotropy_threshold X          -> returned for line orderings
                               (reference doc/user-doc.md:22)
  -matrix_free_jacobian (+ -matrix_free_difference_step E)
                            -> LinearSolverConfig.matrix_free=True with the
                               reference-style FD matvec (matrix_free_fd,
                               fd_eps=E) — the PETSc MATSHELL of
                               alinalg.cpp:124-233
  -mat_type / -options_left / -blasted_thread_* / -benchmark_* -> ignored
    (storage is always slot-block BSR; no threads on TPU)
"""

from __future__ import annotations

import dataclasses

from ..config import LinearSolverConfig


def parse_solverc(path: str) -> dict:
    """Parse a PETSc options file into {name: str-value-or-True}."""
    opts: dict = {}
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#") or line.startswith("!"):
                continue
            if not line.startswith("-"):
                continue
            parts = line.split(None, 1)
            name = parts[0].lstrip("-")
            if len(parts) == 1 or parts[1].startswith("#"):
                opts[name] = True
            else:
                opts[name] = parts[1].split("#")[0].strip()
    return opts


#: PETSc/BLASTed option names that have no TPU-side meaning and are
#: accepted silently.
_IGNORED_PREFIXES = (
    "mat_type", "options_left", "ksp_converged_reason", "log_view",
    "blasted_thread", "blasted_async_fact_init", "blasted_async_apply_init",
    "blasted_async_sweeps", "benchmark_", "threads_sequence",
    "async_build_sweep", "async_apply_sweep", "fvens_log_file",
    "number_of_meshes", "sub_pc_sor", "sub_pc_factor", "pc_gamg_",
    "pc_mg_type",
    "pc_mg_cycle_type", "mg_levels_ksp_type", "mg_levels_ksp_richardson",
    "mg_levels_pc_type", "mg_levels_sub_pc_type", "mg_coarse_ksp_type",
    "mg_coarse_pc_type", "mg_coarse_sub_pc_type",
)


def apply_solver_options(opts: dict,
                         base: LinearSolverConfig = None,
                         warn=None) -> tuple:
    """Translate parsed options onto
    (LinearSolverConfig, mesh_reorder, mesh_anisotropy_threshold).

    mesh_reorder is '' when the file does not specify one;
    mesh_anisotropy_threshold is None when unspecified (the line-ordering
    default applies). `warn` (callable) receives a message for each
    unrecognized option."""
    lin = base if base is not None else LinearSolverConfig()
    reorder = ""
    aniso = None
    updates: dict = {}

    ksp = str(opts.get("ksp_type", "fgmres"))
    if ksp not in ("fgmres", "gmres", "richardson"):
        if warn:
            warn(f"solverc: ksp_type '{ksp}' unsupported; using FGMRES")

    if "ksp_rtol" in opts:
        updates["rtol"] = float(opts["ksp_rtol"])
        updates["rtol_adapt"] = False
    if "ksp_max_it" in opts:
        updates["maxiter"] = int(opts["ksp_max_it"])
    if any(k.startswith("ksp_") for k in opts):
        # the PETSc GMRES restart default (30) applies to anything the
        # options file leaves unspecified
        updates["restart"] = int(opts.get(
            "ksp_gmres_restart",
            min(30, updates.get("maxiter", lin.maxiter))))

    pc_type = str(opts.get("pc_type", "")).lower()
    sub_pc = str(opts.get("sub_pc_type", "")).lower()
    blasted = str(opts.get("blasted_pc_type", "")).lower()
    if pc_type == "gamg":
        updates["pc"] = "amg"
        if "pc_mg_levels" in opts:
            updates["mg_levels"] = max(1, int(opts["pc_mg_levels"]) - 1)
        if "mg_levels_ksp_max_it" in opts:
            nu = int(opts["mg_levels_ksp_max_it"])
            updates["mg_nu1"] = nu
            updates["mg_nu2"] = nu
        if "mg_coarse_ksp_max_it" in opts:
            updates["mg_coarse_sweeps"] = int(opts["mg_coarse_ksp_max_it"])
    elif pc_type in ("bjacobi", "asm", ""):
        if sub_pc == "shell" and blasted:
            sub_pc = blasted        # BLASTed plugged in as the sub-PC
        if sub_pc in ("ilu", "ilu0"):
            # measured TPU equivalent of bjacobi+ILU0 strength
            # (docs/BENCH_NOTES.md round-2 preconditioner study)
            updates["pc"] = "bsgs"
            updates["pc_sweeps"] = 6
        elif sub_pc in ("sor", "sgs"):
            updates["pc"] = "bcsgs"
            updates["pc_sweeps"] = 1
        elif sub_pc in ("jacobi",):
            updates["pc"] = "bjacobi"
        elif sub_pc and warn:
            warn(f"solverc: sub_pc_type '{sub_pc}' unmapped; keeping "
                 f"pc='{lin.pc}'")
    elif pc_type in ("jacobi", "pbjacobi"):
        updates["pc"] = "bjacobi"
    elif pc_type and warn:
        warn(f"solverc: pc_type '{pc_type}' unmapped; keeping "
             f"pc='{lin.pc}'")

    if "mesh_reorder" in opts:
        reorder = str(opts["mesh_reorder"])
    if "mesh_anisotropy_threshold" in opts:
        aniso = float(opts["mesh_anisotropy_threshold"])

    # -matrix_free_jacobian / -matrix_free_difference_step: the reference's
    # FD Jacobian shell (alinalg.cpp:124-233; shipped in
    # tests/solvers/matfree.solverc and testcases/visc-naca0012/opts.solverc
    # as a commented default). matrix_free_fd=True selects the
    # reference-style (r(u+px)-r(u))/p matvec, not the exact JVP, so the
    # options file means what it meant under PETSc.
    if opts.get("matrix_free_jacobian"):
        updates["matrix_free"] = True
        updates["matrix_free_fd"] = True
    if "matrix_free_difference_step" in opts:
        updates["fd_eps"] = float(opts["matrix_free_difference_step"])

    known = {"ksp_type", "ksp_rtol", "ksp_max_it", "ksp_gmres_restart",
             "pc_type", "sub_pc_type", "blasted_pc_type", "pc_mg_levels",
             "mg_levels_ksp_max_it", "mg_coarse_ksp_max_it", "mesh_reorder",
             "mesh_anisotropy_threshold", "matrix_free_jacobian",
             "matrix_free_difference_step"}
    for name in opts:
        if name in known:
            continue
        if any(name.startswith(p) for p in _IGNORED_PREFIXES):
            continue
        if warn:
            warn(f"solverc: option '-{name}' ignored")

    return dataclasses.replace(lin, **updates), reorder, aniso


def load_solver_options(path: str, base: LinearSolverConfig = None,
                        warn=None) -> tuple:
    """parse + apply in one call ->
    (LinearSolverConfig, mesh_reorder, mesh_anisotropy_threshold)."""
    return apply_solver_options(parse_solverc(path), base=base, warn=warn)
