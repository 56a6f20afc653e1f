"""Steady-state pseudo-time continuation: explicit forward Euler and
implicit backward Euler.

PyTorch port of the JAX package's SteadyForwardEuler and
SteadyBackwardEuler, mirroring the reference's SteadyForwardEulerSolver and
SteadyBackwardEulerSolver (FVENS src/ode/aodesolver.cpp:136-638):

  - residual norm = sqrt( sum_cells r_energy^2 * area )  (:516-527)
  - convergence on resi/initres with initres from the first step, or on an
    absolute residual (PseudoTimeConfig.tol_abs)
  - exponential residual-based CFL ramp
    CFL_{n+1} = clamp(CFL_n * (res_{n-1}/res_n)^p)  (:110-120)
  - explicit step: u += cfl_init dt/Vol rhs with local time steps (the
    reference applies cfl_init, not a ramped CFL, aodesolver.cpp:249)
  - implicit step: (Vol/(CFL dt) I + J1) du = rhs, u += omega du with the
    first-order Jacobian J1 (defect-correction quasi-Newton)
  - NaN residual -> NumericalError; non-convergence -> ToleranceError.

Each step runs eagerly on the tensors' device; the scalar control flow (CFL
ramp, Krylov forcing, recovery) stays on the host, fed by one residual
fetch per step. The linear solve takes one of the JAX package's two paths
(its steady.py:350-424):

  - banded, where LinearSolverConfig.banded is set, the mesh is
    band-coverable and pc is bjacobi or bsgs: with LinearSolverConfig.pallas
    and CUDA tensors the matvec is one launch of the banded-apply kernel
    and the whole bsgs preconditioner apply (D^-1 v and the sweeps) one
    launch of the fused bsgs kernel, both in solver/banded_kernels.py;
    otherwise (pallas=False, or CPU tensors) the plain PyTorch twins of
    solver/banded.py. The bjacobi preconditioner is the plain D^-1 v
    contraction on both. The kernels take the flow equations' 4x4 blocks
    and the scalar diffusion's (DiffusionFV) 1x1 blocks;
  - the gather path everywhere else (the JAX package's default): the slot
    matvec and make_preconditioner of solver/linear.py (none, bjacobi,
    bsgs, bcsgs, ilu0, bline, amg), plain PyTorch; the ilu0, bline and amg
    structures are built once per mesh on the host (_ilu, _lines, _mg) and
    kept on the mesh's device.

With LinearSolverConfig.matrix_free the Krylov matvec is not the assembled
Jacobian (which still builds the preconditioner) but, as in the JAX
package, the exact JVP of the residual plus the pseudo-time diagonal
(torch.func.jvp, at the Krylov precision) or, with matrix_free_fd, the
reference's finite-difference shell at the state's full precision; the
matrix-free path never takes the banded operators. warm_start starts each
Krylov solve from the previous Newton direction (zeroed on the device if
it is not finite); deflation_k > 0 runs gmres_dr (GCRO-DR recycling) once
the residual is below deflation_start_relres of the first, carrying its
recycled space from step to step and dropping it after a recovery, a
frozen-residual reset or when the gate closes.

The solve resumes from `checkpoint_path` where that file exists and saves
the state and the controller every `checkpoint_every` accepted steps;
`functional_fn` is evaluated on the new state every `functional_every`
steps and its values join the logger's record, as in the JAX package.

A rank of a distributed solve (dist/shard.py: DistributedBackwardEuler)
inherits the host loop and these operators: the residual with its halo
hook, a part's banded operators with its rest list (on the card K1 for the
bands and, for bsgs, K1's seven-launch sequence, the rest added after each
launch), and the checkpoint's state from all ranks.

Not ported, and refused with NotImplementedError: on-device chunked
stepping (device_steps), pipelined stepping and baked-mesh programs.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import (LinearSolverConfig, NonlinearUpdateConfig,
                      PseudoTimeConfig)
from ..io_config.checkpoint import load_checkpoint, save_checkpoint
from ..io_config.logs import ConvergenceLogger
from . import jacobian as jacmod
from .banded import (BandedStructure, banded_blocks, banded_dn_blocks,
                     banded_structure, make_banded_bsgs, make_banded_matvec,
                     rest_blocks, rest_dn_blocks)
from .banded_kernels import (make_banded_bsgs_kernel,
                             make_banded_bsgs_sequence,
                             make_banded_matvec_kernel)
from .ilu import ilu_structure
from .linear import (BlockJacobian, block_jacobi_inverse, gmres, gmres_dr,
                     make_bsr_matvec, make_preconditioner)
from .lines import lines_from_mesh
from .multigrid import build_hierarchy
from .relaxation import get_update_scheme


class NumericalError(ArithmeticError):
    """Residual became NaN/inf (ref aerrorhandling.hpp:16-40)."""


class ToleranceError(RuntimeError):
    """Did not converge to tolerance within max iterations; `info` is the
    solve's SolveInfo."""

    def __init__(self, msg, info=None):
        super().__init__(msg)
        self.info = info


@dataclasses.dataclass
class SolveInfo:
    converged: bool = False
    steps: int = 0
    initres: float = 0.0
    finalres: float = 0.0
    total_lin_iters: int = 0
    walltime: float = 0.0
    # (step, res/initres, res, cfl, lin_iters) per accepted step
    history: list = dataclasses.field(default_factory=list)
    # (seconds, lin_iters) per step call, retried steps included
    step_times: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class BandedOperators:
    """The banded Krylov operators of one implicit step."""
    bl: BandedStructure
    D: torch.Tensor        # (NC, V, V) diagonal blocks, pseudo-time term in
    Dinv: torch.Tensor     # (NC, V, V) their inverses
    Bt: torch.Tensor       # (K, V, V, NC) band blocks of N
    DNbt: torch.Tensor     # (K, V, V, NC) band blocks of D^-1 N
    R: Optional[torch.Tensor] = None     # (NR, V, V) rest blocks of N
    DNr: Optional[torch.Tensor] = None   # (NR, V, V) rest blocks of D^-1 N


def banded_operators(bl, jac) -> BandedOperators:
    """The banded operators of a BlockJacobian on a band-covered mesh, or
    on a part of a partitioned mesh with its rest list."""
    Dinv = block_jacobi_inverse(jac.D)
    return BandedOperators(bl, jac.D, Dinv, banded_blocks(bl, jac.N),
                           banded_dn_blocks(bl, Dinv, jac.N),
                           rest_blocks(bl, jac.N),
                           rest_dn_blocks(bl, Dinv, jac.N))


@dataclasses.dataclass
class GatherOperators:
    """The slot-gather Krylov operators of one implicit step: the Jacobian
    in per-cell-slot block form on the mesh whose neighbour slots they
    gather (at the Krylov precision), the preconditioner's per-mesh
    structure where it needs one, and the matrix-free matvec in place of
    the Jacobian's where LinearSolverConfig.matrix_free is set."""
    mesh: object           # the CompiledMesh
    jac: BlockJacobian
    lines: object = None   # solver/lines.py LineStructure (pc='bline')
    mg: object = None      # solver/multigrid.py MGHierarchy (pc='amg')
    ilu: object = None     # solver/ilu.py ILUStructure (pc='ilu0')
    matvec: Optional[object] = None


def _residual(space, mesh, u, gettimesteps, exchange=None):
    """space.compute_residual, with the halo hook where one is given (the
    flow residual takes it; a distributed solve passes one)."""
    if exchange is None:
        return space.compute_residual(mesh, u, gettimesteps)
    return space.compute_residual(mesh, u, gettimesteps, exchange=exchange)


def residual_norm(mesh, rhs):
    """Energy-component L2 norm weighted by cell area (aodesolver.cpp:516-527)."""
    r = rhs[:, -1] if rhs.dim() == 2 else rhs
    return torch.sqrt(((r * r) * mesh.area * mesh.cell_mask).sum())


def linear_ramp(cstart, cend, itstart, itend, itcur):
    """Step-indexed linear CFL ramp (SteadySolver::linearRamp,
    aodesolver.cpp:88-108), host scalars."""
    if itcur < itstart:
        return float(cstart)
    if itcur < itend:
        if itend - itstart <= 0:
            return float(cend)
        slope = (cend - cstart) / (itend - itstart)
        return float(cstart + slope * (itcur - itstart))
    return float(cend)


def controller_advance(cfg, lin, xp, cfl, cfl_cap, rtol, rtol_floor,
                       raise_relres, res, resold, initres, ramped_cfl=None):
    """One CFL-ramp + trust-region-cap + Krylov-forcing controller update,
    the JAX package's arithmetic on host scalars (xp=numpy).

    ramped_cfl: pre-computed CFL (the step-indexed linear ramp) replacing
    the exponential residual-based ramp; the trust-region cap still applies.

    Forcing controller: residual growth or stall -> LOOSEN the Krylov
    tolerance (inexact solves damp nonlinear limit cycles); steady progress
    -> TIGHTEN toward the configured floor. Growth AT the floor raises the
    floor (a ratchet); the floor decays back once the residual falls 100x
    below the level where the limit cycle lived, else the loose directions
    stall the deep-convergence endgame near the precision floor.
    """
    ratio = resold / res
    if ramped_cfl is None:
        p = xp.where(ratio > 1.0, 0.25, 0.3)
        cfl = xp.clip(cfl * ratio ** p, cfg.cfl_init, cfg.cfl_fin)
    else:
        cfl = ramped_cfl
    cfl_cap = xp.minimum(cfl_cap * 1.05, cfg.cfl_fin)
    cfl = xp.minimum(cfl, cfl_cap)
    if lin.rtol_adapt:
        r2 = res / resold
        grow = r2 > 1.2
        prog = r2 <= 1.0
        at_floor = rtol <= rtol_floor * 1.01
        floor_g = xp.where(at_floor,
                           xp.minimum(rtol_floor * 4.0, lin.rtol_max),
                           rtol_floor)
        raise_g = xp.where(at_floor,
                           xp.maximum(raise_relres, res / initres),
                           raise_relres)
        rtol_g = xp.minimum(xp.maximum(rtol * 2.0, floor_g), lin.rtol_max)
        floor_p = xp.where(res / initres < 1e-2 * raise_relres,
                           xp.maximum(lin.rtol, rtol_floor * 0.7),
                           rtol_floor)
        rtol_p = xp.maximum(rtol * 0.3, floor_p)
        rtol_floor = xp.where(grow, floor_g,
                              xp.where(prog, floor_p, rtol_floor))
        raise_relres = xp.where(grow, raise_g, raise_relres)
        rtol = xp.where(grow, rtol_g, xp.where(prog, rtol_p, rtol))
    return cfl, cfl_cap, rtol, rtol_floor, raise_relres


@dataclasses.dataclass
class SteadyForwardEuler:
    """Explicit local-time-stepping pseudo-time solver. Each step reads its
    residual norm back to the host once, as the JAX package does."""
    space: object                   # FlowFV or DiffusionFV
    cfg: PseudoTimeConfig

    def _step(self, mesh, u):
        rhs, dt = self.space.compute_residual(mesh, u, True)
        # the reference applies cfl_init (not the ramped CFL) in the
        # explicit update (aodesolver.cpp:249), mirrored for parity
        unew = u + (self.cfg.cfl_init * dt * mesh.inv_area)[:, None] * rhs
        return unew, residual_norm(mesh, rhs)

    def solve(self, mesh, u0, log_every: int = 0, logger=None) -> tuple:
        """March from u0 to the configured tolerance; a solve that does not
        converge in cfg.maxiter steps raises ToleranceError (with .info)."""
        u = u0
        info = SolveInfo()
        t0 = time.perf_counter()
        res = initres = 1.0
        step = 0
        if logger is None and log_every:
            logger = ConvergenceLogger(print_every=log_every, label="FE")
        while step < self.cfg.maxiter:
            u, resj = self._step(mesh, u)
            res = resj.item()
            if not np.isfinite(res):
                raise NumericalError("explicit solve diverged: residual NaN/inf")
            if step == 0:
                initres = res
            step += 1
            info.history.append((step, res / initres, res, self.cfg.cfl_init,
                                 0))
            if logger:
                logger.log(step, res / initres, res, cfl=self.cfg.cfl_init)
            if (res / initres <= self.cfg.tol
                    or (self.cfg.tol_abs and res <= self.cfg.tol_abs)):
                break
        info.walltime = time.perf_counter() - t0
        info.steps = step
        info.initres = initres
        info.finalres = res
        info.converged = (res / initres <= self.cfg.tol
                          or bool(self.cfg.tol_abs
                                  and res <= self.cfg.tol_abs))
        if not info.converged:
            raise ToleranceError("explicit steady solve did not converge",
                                 info)
        return u, info


@dataclasses.dataclass
class SteadyBackwardEuler:
    space: object                       # FlowFV or DiffusionFV
    cfg: PseudoTimeConfig
    lin: LinearSolverConfig = LinearSolverConfig()
    nl: NonlinearUpdateConfig = NonlinearUpdateConfig()
    checkpoint_path: Optional[str] = None     # save/resume state here
    checkpoint_every: int = 50
    # (mesh, u) -> (entropy, CL, CDp, CDsf) tensors, e.g. output.
    # make_functionals; every `functional_every` steps its values join the
    # logger's record
    functional_fn: Optional[object] = None
    functional_every: int = 0
    log_label = "BE"      # class attr (not a field): logger prefix

    def _check_supported(self):
        cfg = self.cfg
        missing = [name for name, on in (
            ("PseudoTimeConfig.device_steps > 1", cfg.device_steps > 1),
            ("PseudoTimeConfig.pipeline", cfg.pipeline),
            ("PseudoTimeConfig.bake_mesh", cfg.bake_mesh),
        ) if on]
        if missing:
            raise NotImplementedError(
                "not ported: " + ", ".join(missing))

    def _cached(self, name, mesh, build):
        """A host-built per-mesh structure, cached on the solver."""
        cache = self.__dict__.get(name)
        if cache is None or cache[0] is not mesh:
            cache = (mesh, build(mesh))
            setattr(self, name, cache)
        return cache[1]

    def _lines(self, mesh):
        """Line detection (pc='bline' only), cached per mesh."""
        if self.lin.pc != "bline":
            return None
        return self._cached("_lines_cache", mesh, lines_from_mesh)

    def _mg(self, mesh):
        """The AMG hierarchy (pc='amg' only), cached per mesh."""
        if self.lin.pc != "amg":
            return None
        return self._cached("_mg_cache", mesh, lambda m: build_hierarchy(
            m, n_levels=self.lin.mg_levels))

    def _mg_opts(self):
        return dict(nu1=self.lin.mg_nu1, nu2=self.lin.mg_nu2,
                    coarse_sweeps=self.lin.mg_coarse_sweeps,
                    cycles=self.lin.mg_cycles)

    def _ilu(self, mesh):
        """The ILU0 sparsity analysis (pc='ilu0' only), cached per mesh."""
        if self.lin.pc != "ilu0":
            return None
        return self._cached("_ilu_cache", mesh, ilu_structure)

    def _banded(self, mesh):
        """Host-side band analysis, cached per mesh (LinearSolverConfig.
        banded only). None when banded is off or the mesh is not
        band-coverable: the step then takes the gather path."""
        if not self.lin.banded:
            return None
        return self._cached("_banded_cache", mesh, banded_structure)

    def _kernel_on(self, x):
        """The CUDA banded kernel runs when the config allows it and the
        Krylov tensors are on a CUDA card; pallas=False is the explicit
        plain-PyTorch path."""
        return bool(self.lin.pallas) and x.is_cuda

    def step_operators(self, mesh, u, cfl, lmesh=None, bl=None,
                       exchange=None, allreduce=None):
        """The residual at state u and the Krylov system of one implicit
        step at `cfl`: (rhs, lrhs, ops) with rhs at u's dtype, lrhs and ops
        at the Krylov precision, and ops BandedOperators where the banded
        path applies (band analysis `bl`, pc bjacobi or bsgs, not matrix
        free), else GatherOperators (with the matrix-free matvec where
        LinearSolverConfig.matrix_free is set).

        `lmesh` (optional): precomputed f32 mesh for the mixed-precision
        path (LinearSolverConfig.mixed_precision): the Newton DIRECTION
        tolerates f32 (it is just another inexactness), while the
        residual/update stay f64 so the outer iteration can reach 1e-10.

        `exchange` and `allreduce` (a rank of a distributed solve,
        dist/shard.py): the residual's halo hook and the sum over the
        ranks, which the matrix-free matvec uses too."""
        if bl is None:
            bl = self._banded(mesh)
        rhs, dt = _residual(self.space, mesh, u, True, exchange)

        mixed = self.lin.mixed_precision and u.dtype == torch.float64
        if mixed:
            lmesh = mesh.to(torch.float32) if lmesh is None else lmesh
            lu = u.to(torch.float32)
            lrhs = rhs.to(torch.float32)
            ldt = dt.to(torch.float32)
        else:
            lmesh, lu, lrhs, ldt = mesh, u, rhs, dt

        jac = self.space.assemble_jacobian(lmesh, lu)
        # a Python cfl times an f32 tensor rounds cfl to f32 first
        jac = jacmod.add_pseudotime_term(lmesh, jac, cfl, ldt)
        if (bl is not None and not self.lin.matrix_free
                and self.lin.pc in ("bjacobi", "bsgs")):
            return rhs, lrhs, banded_operators(bl, jac)
        mv = (self._matrix_free_matvec(mesh, lmesh, u, lu, rhs, dt, ldt,
                                       cfl, lrhs.dtype, exchange, allreduce)
              if self.lin.matrix_free else None)
        return rhs, lrhs, self._gather_operators(mesh, lmesh, jac, mv)

    def _gather_operators(self, mesh, lmesh, jac, matvec=None):
        """GatherOperators on `lmesh` with the preconditioner's structure,
        built from (and cached for) the full-precision `mesh`."""
        return GatherOperators(lmesh, jac, lines=self._lines(mesh),
                               mg=self._mg(mesh), ilu=self._ilu(mesh),
                               matvec=matvec)

    def _matrix_free_matvec(self, mesh, lmesh, u, lu, rhs, dt, ldt, cfl,
                            kdt, exchange=None, allreduce=None):
        """The matrix-free Krylov matvec of the JAX package's step, its
        result at the Krylov dtype `kdt`:

          - matrix_free_fd: the reference's finite-difference shell at the
            state's full precision (alinalg.cpp:126,167-202), perturbation
            p = fd_eps/||x||, J x ~ diag x - (rhs(u + p x) - rhs(u))/p;
          - else the exact JVP of -rhs plus the pseudo-time diagonal, at
            the Krylov precision (f32 state and mesh under mixed
            precision).

        Under mixed precision the FD shell still differences at the
        state's f64, the Krylov vector taken up to f64 first (at f32 the
        perturbation's floor 1e-300 is 0, and GMRES's first product, with
        x = 0, would divide by it), and its product lands in the f32 basis,
        so it is cast there. The JAX package cannot run this case: its f64
        product enters its f32 GMRES loop, which refuses the carry.

        On a rank of a distributed solve the caller exchanges the Krylov
        vector's halo before the product; the residuals run with the
        `exchange` hook, and the FD perturbation takes the global norm of
        the owned entries (`allreduce`)."""
        space = self.space
        if self.lin.matrix_free_fd:
            diag = (mesh.area / (cfl * dt) * mesh.cell_mask)[:, None]
            eps0 = self.lin.fd_eps

            def matvec(x):
                x = x.to(u.dtype)
                if allreduce is None:
                    nrm2 = (x * x).sum()
                else:
                    nrm2 = allreduce(((x * mesh.cell_mask[:, None]) ** 2)
                                     .sum())
                p = eps0 / torch.clamp_min(torch.sqrt(nrm2), 1e-300)
                rp = _residual(space, mesh, u + p * x, False, exchange)[0]
                return (diag * x - (rp - rhs) / p).to(kdt)
            return matvec
        diag = (lmesh.area / (cfl * ldt) * lmesh.cell_mask)[:, None]

        def residual(v):
            return _residual(space, lmesh, v, False, exchange)[0]

        def matvec(x):
            _, tang = torch.func.jvp(residual, (lu,), (x,))
            return diag * x - tang
        return matvec

    def _linear_operators(self, ops):
        """(matvec, pc): on the gather path the slot matvec and
        make_preconditioner; on the banded path the CUDA kernels' (the
        matvec and the fused bsgs apply; with a rest list the matvec plus
        the rest, and the seven-launch sequence plus the rest) or the plain
        twins', with bjacobi the plain D^-1 v contraction on both."""
        lin = self.lin
        if isinstance(ops, GatherOperators):
            mv = (ops.matvec if ops.matvec is not None
                  else make_bsr_matvec(ops.mesh, ops.jac))
            return mv, make_preconditioner(
                ops.mesh, ops.jac, lin.pc, lin.pc_sweeps, lines=ops.lines,
                mg=ops.mg, mg_opts=self._mg_opts(), ilu=ops.ilu,
                ilu_setup=lin.ilu_setup_sweeps)
        kernel = self._kernel_on(ops.D)
        bl = ops.bl
        make_mv = make_banded_matvec_kernel if kernel else make_banded_matvec
        mv = make_mv(ops.D, ops.Bt, bl.offsets, bl, ops.R)
        if lin.pc == "bjacobi":
            Dinv = ops.Dinv
            return mv, lambda v: torch.einsum("cij,cj->ci", Dinv, v)
        if kernel and ops.DNr is None:
            return mv, make_banded_bsgs_kernel(ops.Dinv, ops.DNbt,
                                               bl.offsets, lin.pc_sweeps,
                                               bl.support)
        # a part with a rest list: on the card the seven-launch sequence
        # with the rest blocks after each launch
        make_pc = make_banded_bsgs_sequence if kernel else make_banded_bsgs
        return mv, make_pc(ops.Dinv, ops.DNbt, bl.offsets, lin.pc_sweeps,
                           bl, ops.DNr)

    def _step(self, mesh, u, cfl, rtol, omega_cap=1.0, lmesh=None, bl=None,
              du0=None, U0=None, defl=False, return_carry=False):
        """One implicit pseudo-time step. Returns (unew, res, lin_iters) with
        res a host float (NaN when any residual/state/update component is
        non-finite); with `return_carry` also du, the Newton direction at
        u's dtype, and U, the recycled space gmres_dr returns (None unless
        `defl`).

        `du0`: the previous direction as the Krylov initial guess
        (warm_start), zeroed on the device where any entry is not finite.
        `defl`: solve with gmres_dr (GCRO-DR, deflation_k directions),
        recycling `U0` (None: a first solve that only harvests)."""
        rhs, lrhs, ops = self.step_operators(mesh, u, cfl, lmesh, bl)
        matvec, pc = self._linear_operators(ops)

        if du0 is not None:
            x0 = du0.to(lrhs.dtype)
            # a non-finite stale guess must never poison the solve
            x0 = torch.where(torch.isfinite(x0).all(), x0,
                             torch.zeros_like(x0))
        else:
            x0 = torch.zeros_like(lrhs)
        U = None
        if defl:
            du, iters, relres, U = gmres_dr(
                matvec, lrhs, x0, pc, U=U0, k=self.lin.deflation_k,
                restart=self.lin.restart, maxiter=self.lin.maxiter,
                rtol=rtol)
        else:
            du, iters, relres = gmres(matvec, lrhs, x0, pc,
                                      restart=self.lin.restart,
                                      maxiter=self.lin.maxiter, rtol=rtol)
        du = du.to(u.dtype)
        unew = u + self._update_factor(u, du, omega_cap)[:, None] * du
        # poison the reported norm if ANY residual/state component is
        # non-finite (the energy norm alone can stay finite while momentum
        # components are NaN, silently freezing the solve)
        ok = (torch.isfinite(rhs).all() & torch.isfinite(unew).all()
              & torch.isfinite(du).all())
        res = torch.where(ok, residual_norm(mesh, rhs),
                          torch.full((), float("nan"), dtype=rhs.dtype,
                                     device=rhs.device)).item()
        if not np.isfinite(relres):
            res = float("nan")
        if return_carry:
            return unew, res, iters, du, U
        return unew, res, iters

    def _update_factor(self, u, du, omega_cap):
        """The per-cell factor omega of the update u + omega du: the
        nonlinear update scheme's, capped at omega_cap, then scaled by a
        per-cell positivity line search for the flow equations."""
        phy = self.space.phy            # None for DiffusionFV
        omega = get_update_scheme(self.nl.scheme)(phy, u, du,
                                                  self.nl.min_factor)
        omega = torch.clamp_max(omega, omega_cap)

        if phy is not None and u.shape[-1] == 4:
            # per-cell positivity line search (beyond the reference, which
            # can accept negative-pressure states at high CFL and NaN on the
            # next step): halve the local factor until density and pressure
            # stay above 1% of their current values; 0 if even 1/32 fails
            rho0 = u[:, 0]
            p0 = phy.pressure(u)

            def positive(om):
                ut = u + (omega * om)[:, None] * du
                return ((ut[:, 0] > 0.01 * rho0)
                        & (phy.pressure(ut) > 0.01 * p0))

            scale = torch.zeros_like(omega)
            for om in (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125):
                scale = torch.where((scale == 0.0) & positive(om), om, scale)
            omega = omega * scale
        return omega

    def _checkpoint_state(self, u):
        """The array a checkpoint stores for state u (None: this process
        writes no checkpoint)."""
        return u

    def _resume_state(self, saved):
        """This solver's state from a checkpoint's stored array."""
        return saved

    def solve(self, mesh, u0, log_every: int = 0, logger=None,
              max_steps: Optional[int] = None) -> tuple:
        """Run the continuation from u0 (or from the checkpoint) to the
        configured tolerance. `logger` (io_config.logs.ConvergenceLogger or
        any object with its `log`) receives every accepted step; with
        `log_every` and no logger, one that prints every `log_every` steps.

        `max_steps` stops after that many accepted steps of this call and
        returns without the convergence verdict (for step-by-step
        comparisons); otherwise a solve that does not converge raises
        ToleranceError."""
        self._check_supported()
        bl = self._banded(mesh)
        mixed = self.lin.mixed_precision and u0.dtype == torch.float64
        lmesh = mesh.to(torch.float32) if mixed else mesh

        u = u0
        info = SolveInfo()
        t0 = time.perf_counter()
        res = resold = initres = 1.0
        cfl = self.cfg.cfl_init
        step = 0
        if logger is None and log_every:
            logger = ConvergenceLogger(print_every=log_every,
                                       label=self.log_label)

        rtol = 0.1 if self.lin.rtol_adapt else self.lin.rtol
        rtol_floor = self.lin.rtol
        raise_relres = 0.0    # relres level of the last floor raise
        resumed_cap = 0.0

        # resume from a checkpoint if one exists (absent in the reference:
        # controlparser.hpp:24 parses init_soln_file but never implements it)
        if self.checkpoint_path:
            if os.path.exists(self.checkpoint_path):
                ck = load_checkpoint(self.checkpoint_path)
                u = torch.as_tensor(self._resume_state(ck["u"]),
                                    dtype=u0.dtype, device=u0.device)
                step = ck["step"]
                cfl = ck["cfl"] or cfl
                res = resold = ck["res"] or 1.0
                initres = ck["initres"] or 1.0
                # restore the full controller state so the resumed solve
                # CONTINUES the interrupted trajectory
                rtol = float(ck.get("x_rtol", rtol))
                rtol_floor = float(ck.get("x_rtol_floor", rtol_floor))
                raise_relres = float(ck.get("x_raise_relres", 0.0))
                resold = float(ck.get("x_resold", resold))
                resumed_cap = float(ck.get("x_cfl_cap", 0.0))
                print(f"  resumed from {self.checkpoint_path} at step {step}")
        nsteps = (self.cfg.maxiter if max_steps is None
                  else min(step + max_steps, self.cfg.maxiter))

        nan_retries = 0
        omega_cap = 1.0
        u_good = u            # last state whose residual evaluated healthy
        u_best, res_best = u, float("inf")   # lowest-residual state seen
        stall_count = 0
        # trust-region cap, shrinks on failures (restored across resume)
        cfl_cap = resumed_cap if resumed_cap > 0 else float("inf")
        warm = self.lin.warm_start
        defl = self.lin.deflation_k > 0
        du_prev = torch.zeros_like(u) if warm else None
        U_defl = None           # recycled Krylov space (lin.deflation_k)
        while step < nsteps:
            if step > 0:
                rc = (linear_ramp(self.cfg.cfl_init, self.cfg.cfl_fin,
                                  self.cfg.rampstart, self.cfg.rampend,
                                  step)
                      if self.cfg.cfl_ramp == "linear" else None)
                cfl, cfl_cap, rtol, rtol_floor, raise_relres = [
                    float(x) for x in controller_advance(
                        self.cfg, self.lin, np, cfl, cfl_cap, rtol,
                        rtol_floor, raise_relres, res, resold, initres,
                        ramped_cfl=rc)]
            u_prev = u
            # GCRO-DR only below deflation_start_relres: during the
            # transient the Jacobian changes violently between steps and a
            # recycled space is stale
            defl_on = (defl and step > 0
                       and res <= self.lin.deflation_start_relres * initres)
            if not defl_on:
                U_defl = None     # space from before a recovery/gate-close
            ts = time.perf_counter()
            u, res_new, iters, du, U_new = self._step(
                mesh, u, cfl, rtol, omega_cap, lmesh=lmesh, bl=bl,
                du0=du_prev, U0=U_defl, defl=defl_on, return_carry=True)
            if warm:
                du_prev = du
            if defl_on:
                U_defl = U_new
            info.step_times.append((time.perf_counter() - ts, iters))
            fnl_log = {}
            if (self.functional_fn is not None and self.functional_every
                    and (step + 1) % self.functional_every == 0):
                fnl_log = dict(zip(("entropy", "CL", "CDp", "CDsf"),
                                   torch.stack(self.functional_fn(mesh, u))
                                   .tolist()))
            resold = res
            res = res_new
            info.total_lin_iters += iters
            finite = np.isfinite(res)
            # numerical blowup: finite residual but far beyond any physical
            # transient (shock-formation transients peak ~1e2-1e3 x initres;
            # 1e5+ means the continuation left the basin entirely)
            blown = (finite and step > 0
                     and res > self.cfg.blowup_relres * initres)
            if finite and not blown:
                # the residual was evaluated at u_prev: u_prev is certified
                u_good = u_prev
                if res < res_best:
                    u_best, res_best = u_prev, res
                nan_retries = 0
                omega_cap = 1.0
            if not finite or blown:
                # divergence guard (beyond the reference, which throws on
                # NaN and accepts any finite residual): back off at a much
                # smaller CFL. NaN retries resume locally (u_good); blowups
                # restart from the best-seen state, since every state on
                # the divergent branch is polluted.
                nan_retries += 1
                if nan_retries > 5:
                    raise NumericalError(
                        "implicit solve diverged: residual NaN/inf")
                if blown and res_best < float("inf"):
                    u = u_best
                    res = resold = res_best
                else:
                    u = u_good
                    res = resold
                # shrink the trust region: cap future CFL well below the
                # failure level (it re-expands 5%/step on success)
                cfl_cap = max(cfl * 0.25, 1.0)
                cfl = max(cfl * 0.1, 1.0)
                if blown:
                    # blowups are fed by too-loose linear solves during the
                    # shock phase: reset the forcing ratchet and solve tight
                    rtol = rtol_floor = self.lin.rtol
                else:
                    rtol = self.lin.rtol_max
                omega_cap = 0.2        # heavily damped recovery steps
                if warm:
                    du_prev = torch.zeros_like(u)   # drop the stale guess
                U_defl = None          # drop the stale recycle space
                kind = "blowup" if blown else "NaN residual"
                print(f"  BE: {kind}, retrying from "
                      f"{'best' if blown else 'previous'} state at CFL "
                      f"{cfl:.1f}, omega<=0.2 (retry {nan_retries}/5)")
                continue
            # frozen-state guard: a bit-identical residual means the update
            # was fully rejected (e.g. the positivity line search zeroed a
            # garbage Krylov direction at too-high CFL for f32): cut CFL
            # and tighten the linear solves, else the solve spins forever
            if (step > 0 and resold > 0.0
                    and abs(res / resold - 1.0) < 1e-12
                    and res / initres > self.cfg.tol):
                stall_count += 1
                if stall_count >= 4:
                    cfl_cap = max(cfl * 0.25, 1.0)
                    cfl = max(cfl * 0.1, 1.0)
                    rtol = rtol_floor = self.lin.rtol
                    stall_count = 0
                    U_defl = None      # drop the stale recycle space
                    print(f"  BE: frozen residual, dropping to CFL "
                          f"{cfl:.1f} with tight linear solves")
            else:
                stall_count = 0
            if step == 0:
                initres = res
                resold = res
            step += 1
            info.history.append((step, res / initres, res, cfl, iters))
            if logger:
                logger.log(step, res / initres, res, lin_iters=int(iters),
                           cfl=cfl, **fnl_log)
            if (self.checkpoint_path and self.checkpoint_every
                    and step % self.checkpoint_every == 0):
                state = self._checkpoint_state(u)
                if state is not None:
                    save_checkpoint(self.checkpoint_path, state, step=step,
                                    cfl=cfl, res=res, initres=initres,
                                    extra={"rtol": rtol,
                                           "rtol_floor": rtol_floor,
                                           "raise_relres": raise_relres,
                                           "resold": resold,
                                           "cfl_cap": min(cfl_cap, 1e300)})
            if (res / initres <= self.cfg.tol
                    or (self.cfg.tol_abs and res <= self.cfg.tol_abs)):
                break
        info.walltime = time.perf_counter() - t0
        info.steps = step
        info.initres = initres
        info.finalres = res
        info.converged = (res / initres <= self.cfg.tol
                          or bool(self.cfg.tol_abs
                                  and res <= self.cfg.tol_abs))
        if not info.converged and max_steps is None:
            raise ToleranceError("implicit steady solve did not converge",
                                 info)
        return u, info
