"""One rank's part of a domain-decomposed flow solve over torch.distributed.

The port of the JAX package's dist/shard.py. There, one shard_map program
runs every part on its device; here every rank is a process (launch.py)
that holds one part's local mesh (partition.py) and runs the single-device
functions on it, with the reference's MPI layer (ghosted PETSc Vecs +
L2TraceVector Isend/Irecv + MPI_Allreduce, SURVEY.md sec 2.9) mapped to:

  forward halo INSERT  -> comm.halo_exchange: R rounds of point-to-point
                          messages from the owners into the halo slots
  reverse halo ADD     -> unnecessary: cross-partition faces are computed
                          redundantly by both owners (like the reference's
                          connectivity faces, flow_spatial.cpp:499-502)
  MPI_Allreduce norms  -> comm.allreduce_sum / allreduce_min

A rank's state is its part's (NC_local, V) slab: own cells first, then halo
cells, then padding.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from ..solver import jacobian as jacmod
from ..solver.banded import banded_structure_parts
from ..solver.linear import (EAGER, gmres, gmres_device, gmres_dr,
                             make_bsr_matvec, make_preconditioner)
from ..solver.relaxation import get_update_scheme
from ..solver.steady import SteadyBackwardEuler
from .comm import (Comm, Exchange, all_gather_rows, allreduce_min,
                   allreduce_sum, halo_exchange)
from .partition import ShardedMeshBundle


@dataclasses.dataclass
class ShardedFlow:
    """One rank's executor of a distributed flow: the spatial
    discretization `space` (a FlowFV, its single-device functions reused as
    they are) on part `comm.rank` of `bundle`, on `comm.device`."""
    space: object
    bundle: ShardedMeshBundle
    comm: Comm
    dtype: torch.dtype = torch.float64
    # the notices rank 0 has printed (shared by the flows of one case)
    said: set = dataclasses.field(default_factory=set, repr=False)

    def __post_init__(self):
        self.mesh, maps = self.bundle.part(self.comm.rank, self.comm.device,
                                           self.dtype)
        self.exch = Exchange.build(self.comm, maps)
        self.n_parts = self.bundle.n_parts

    def _local_residual(self, u, gettimesteps=True):
        """This rank's residual: the single-device pipeline with the halo
        hook threaded in (FlowFV.compute_residual(exchange=...)): u is
        exchanged first, the gradients inside face_states (the reference's
        VecGhostUpdate on gradvec, flow_spatial.cpp:710-729). Returns
        (exchanged u, rhs, dt)."""
        u = halo_exchange(self.exch, u)
        rhs, dt = self.space.compute_residual(
            self.mesh, u, gettimesteps,
            exchange=partial(halo_exchange, self.exch))
        return u, rhs, dt

    def residual(self, u):
        """(rhs, dt) of this rank's part at its slab u (NC_local, V)."""
        _, rhs, dt = self._local_residual(u)
        return rhs, dt

    def fe_step(self, u, cfl: float):
        """One explicit forward-Euler step: (u', global residual norm as a
        host float)."""
        m = self.mesh
        u1, rhs, dt = self._local_residual(u)
        unew = u1 + (cfl * dt * m.inv_area)[:, None] * rhs
        r = rhs[:, -1]
        loc = ((r * r) * m.area * m.cell_mask).sum()
        return unew, float(torch.sqrt(allreduce_sum(self.comm, loc)))

    def be_step(self, u, cfl: float, rtol: float, lin=None, nl=None):
        """One distributed implicit pseudo-time step, the twin of the JAX
        package's ShardedFlow.be_step_fn: the reference's parallel layout
        (PETSc bjacobi: Schwarz across ranks, a strong smoother within).
        On this rank's slab: the halo-exchanged residual, the part-local
        Jacobian with the pseudo-time term, the part-local preconditioner
        make_preconditioner(lin.pc, lin.pc_sweeps) with no halo coupling,
        classic GMRES from zero whose matvec exchanges the Krylov vector at
        every application and whose inner products are summed over the
        ranks, then the update scheme nl.scheme applied locally. Lighter
        than DistributedBackwardEuler._step: its factor omega is the update
        scheme's alone (no cap, no positivity line search), `ok` does not
        test du, and it has no warm start.

        Returns (u', global residual as a host float, NaN unless the
        residual, the new state and GMRES's residual are finite on every
        rank, Krylov iterations)."""
        from ..config import LinearSolverConfig, NonlinearUpdateConfig
        lin = lin or LinearSolverConfig()
        nl = nl or NonlinearUpdateConfig()
        comm, m = self.comm, self.mesh
        ex = partial(halo_exchange, self.exch)
        mask = m.cell_mask[:, None]

        u, rhs, dt = self._local_residual(u)
        jac = self.space.assemble_jacobian(m, u)
        jac = jacmod.add_pseudotime_term(m, jac, cfl, dt)
        # part-local preconditioner (additive Schwarz, no halo coupling)
        pc = make_preconditioner(m, jac, lin.pc, lin.pc_sweeps)
        mv = make_bsr_matvec(m, jac)

        def matvec(x):
            return mv(ex(x)) * mask

        du, iters, relres = gmres(
            matvec, rhs * mask, torch.zeros_like(rhs),
            lambda v: pc(v) * mask, restart=lin.restart,
            maxiter=lin.maxiter, rtol=rtol, blocked=False,
            allreduce=partial(allreduce_sum, comm))
        omega = get_update_scheme(nl.scheme)(self.space.phy, u, du,
                                             nl.min_factor)
        unew = u + omega[:, None] * du * mask

        loc = ((rhs[:, -1] ** 2) * m.area * m.cell_mask).sum()
        res = torch.sqrt(allreduce_sum(comm, loc))
        ok = (torch.isfinite(rhs).all() & torch.isfinite(unew).all()
              & bool(np.isfinite(relres)))
        ok = allreduce_min(comm, ok.to(torch.int32).reshape(1))
        return unew, float(res) if int(ok) else float("nan"), iters

    def say_once(self, notice: str):
        """Print `notice` on rank 0, once per set of flows sharing `said`."""
        if self.comm.rank == 0 and notice not in self.said:
            self.said.add(notice)
            print(notice, flush=True)

    def initial_state(self):
        """The free stream on every local slot."""
        return self.space.uinf(self.dtype, self.comm.device).repeat(
            self.mesh.NC, 1)

    def scatter(self, u_global):
        """This rank's slab of a global (n_cells, V) state: its own cells
        from u_global, the halo and padding slots at the free stream (an
        exchange fills the halo)."""
        b, p = self.bundle, self.comm.rank
        n = int(b.own_counts[p])
        u = self.initial_state()
        u[:n] = torch.as_tensor(np.asarray(u_global)[b.own_gid[p, :n]],
                                dtype=self.dtype, device=self.comm.device)
        return u

    def gather_solution(self, u):
        """The global (n_cells, V) state as a NumPy array on rank 0 (None on
        the others), in global cell order; every rank must call it."""
        b = self.bundle
        stacked = all_gather_rows(self.comm, u)
        if self.comm.rank != 0:
            return None
        u_np = stacked.double().cpu().numpy()
        out = np.zeros((b.n_cells_global,) + u_np.shape[2:])
        for p in range(b.n_parts):
            n_own = int(b.own_counts[p])
            out[b.own_gid[p, :n_own]] = u_np[p, :n_own]
        return out

    def dist_mesh(self) -> "DistMesh":
        """The handle DistributedBackwardEuler takes in place of a mesh."""
        return DistMesh(self.mesh, self.exch)

    def solve_implicit(self, cfg, lin=None, nl=None, u=None,
                       log_every: int = 0, logger=None,
                       checkpoint_path=None, checkpoint_every: int = 50,
                       max_steps=None):
        """The distributed implicit solve: the full SteadyBackwardEuler host
        controller (see DistributedBackwardEuler) from u (default: the free
        stream). cfg: PseudoTimeConfig. Returns (u, SolveInfo)."""
        from ..config import LinearSolverConfig, NonlinearUpdateConfig
        be = DistributedBackwardEuler(
            space=self.space, cfg=cfg, lin=lin or LinearSolverConfig(),
            nl=nl or NonlinearUpdateConfig(), checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, flow=self)
        if u is None:
            u = self.initial_state()
        return be.solve(self.dist_mesh(), u, log_every=log_every,
                        logger=logger, max_steps=max_steps)


@dataclasses.dataclass(frozen=True)
class DistMesh:
    """Stands in for a CompiledMesh in the inherited
    SteadyBackwardEuler.solve host loop: this rank's part mesh and its halo
    exchange, with the one mesh operation the loop performs (the
    mixed-precision copy)."""
    mesh: object                  # CompiledMesh of this rank's part
    exch: Exchange

    def to(self, dtype) -> "DistMesh":
        return DistMesh(self.mesh.to(dtype), self.exch)


# what rank 0 of a solve with pipeline or bake_mesh prints once on the
# host-staged route
STAGED_NOTICE = (
    "fvens_tpu_torch: pipeline and bake_mesh run the host loop on the "
    "gloo, host-staged route (ranks sharing a card): a message passes "
    "through host memory, so the step cannot stay on the card")


@dataclasses.dataclass
class DistributedBackwardEuler(SteadyBackwardEuler):
    """The distributed implicit solver, reusing SteadyBackwardEuler's host
    controller by inheritance: the CFL ramp and trust-region cap, the
    Krylov forcing controller, NaN/blowup recovery from the best state,
    the frozen-residual guard, checkpoint/resume and mixed precision all
    come from solve() unchanged. It overrides the device step (_step): the
    halo-exchanged residual, the part-local Jacobian, the part-local
    preconditioner (additive Schwarz, the reference's parallel bjacobi
    layout, testcases/defaults.solverc:16-19), GMRES with reduced inner
    products and the positivity line search; the band analysis (_banded:
    per part, with rest lists); and where a checkpoint's state comes from
    and goes to (rank 0 writes the stacked (D, NC_local, V) state, every
    rank reads its slab back).

    Every rank runs the same host loop, and every controller decision
    comes from reduced scalars (the residual norm, `ok` by allreduce_min,
    the Krylov iterations of a GMRES whose every decision is reduced), so
    all ranks take the same path, as the JAX package's shards do.

    `pipeline` and `bake_mesh` run the device form of the step
    (_device_step: gmres_device over reduced inner products, nothing read
    back), the counterpart of the JAX package's one shard_map program per
    step, through the inherited device_stepping programs, as the JAX
    package's inherited solve() pipelines and bakes that program:
      - over NCCL each rank's step is one CUDA graph, its collectives
        captured with it: on one rank inside the Krylov iterations' IF
        nodes, over two or more with the guarded parts captured masked
        (_masked_capture: every iteration runs, its writes selected), the
        collectives at the graph's top level; every decision comes from
        reduced values, so every rank replays the same work in the same
        order, and a speculative step is discarded on every rank alike;
      - over gloo on the CPU it runs eagerly (linear.EAGER), as the
        one-device modes run on the CPU;
      - on the host-staged route (gloo ranks sharing a card, Comm.staged)
        a message passes through host memory, so the host loop runs, and
        rank 0 says so once (STAGED_NOTICE).
    `device_steps` > 1 is refused, as there.
    """
    flow: ShardedFlow = None

    log_label = "dBE"

    def __post_init__(self):
        if self.lin.pc in ("bline", "amg"):
            raise NotImplementedError(
                f"pc={self.lin.pc!r} has no distributed form (in the JAX "
                "package neither: stacking the per-part line/hierarchy "
                "structures needs cross-part shape padding); use bjacobi, "
                "bsgs, bcsgs or ilu0 (part-local additive Schwarz), "
                "optionally banded, matrix-free, warm_start or deflation_k")
        if self.cfg.device_steps > 1:
            raise NotImplementedError(
                "device-side chunked stepping (device_steps>1) is "
                "single-chip only; the distributed step is already one "
                "device program per pseudo-time step")

    @property
    def device_resident(self) -> bool:
        """Whether pipeline and bake_mesh run the device-form step: on
        every route where no message passes through host memory."""
        return not self.flow.comm.staged

    def solve(self, mesh, u0, *args, **kwargs) -> tuple:
        if (self.cfg.pipeline or self.cfg.bake_mesh) \
                and not self.device_resident:
            self.flow.say_once(STAGED_NOTICE)
        return super().solve(mesh, u0, *args, **kwargs)

    def _masked_capture(self) -> bool:
        """Over two or more ranks the step is captured masked (every
        Krylov iteration runs, its writes selected by `live`), its
        collectives at the graph's top level: with NCCL's kernels inside
        an IF node's body graph the capture's end crashes on the card
        (an H100 per rank: PERF.md section 6). One rank keeps the
        IF nodes: its reductions queue no NCCL kernel."""
        return self.flow.comm.size > 1

    def _krylov_blocked(self, n: int) -> bool:
        """A rank's GMRES runs the classic path at any n, as gmres does
        with an allreduce."""
        return False

    def _banded(self, mesh):
        """This rank's part of the partitioned band analysis
        (banded_structure_parts over every part's neighbour table, so the
        offsets are shared), cached; None where lin.banded is off or the
        parts are not band-dominant (the gather path)."""
        if not self.lin.banded:
            return None
        if "_banded_part" not in self.__dict__:
            f = self.flow.bundle.fields
            parts = banded_structure_parts(f["cell_nbrs"], f["nbr_mask"])
            self._banded_part = (None if parts is None else parts.part(
                self.flow.comm.rank, self.flow.comm.device))
        return self._banded_part

    def _checkpoint_state(self, u):
        stacked = all_gather_rows(self.flow.comm, u)
        return stacked.cpu().numpy() if self.flow.comm.rank == 0 else None

    def _resume_state(self, saved):
        want = (self.flow.n_parts, self.flow.mesh.NC)
        if tuple(saved.shape[:2]) != want:
            raise ValueError(f"checkpoint state of shape {saved.shape}; this "
                             f"partition needs {want + (saved.shape[-1],)}")
        return saved[self.flow.comm.rank]

    def _step(self, dmesh, u, cfl, rtol, omega_cap=1.0, lmesh=None, bl=None,
              du0=None, U0=None, defl=False, return_carry=False):
        """SteadyBackwardEuler._step's contract on this rank's slab u
        (NC_local, V): (u', global residual, Krylov iterations)
        [+ du, U]."""
        comm = self.flow.comm
        mesh = dmesh.mesh
        ex = partial(halo_exchange, dmesh.exch)
        ar = partial(allreduce_sum, comm)
        u = ex(u)
        rhs, lrhs, ops = self.step_operators(
            mesh, u, cfl, None if lmesh is None else lmesh.mesh, bl,
            exchange=ex, allreduce=ar)
        mv, pc = self._linear_operators(ops)
        mask = mesh.cell_mask[:, None].to(lrhs.dtype)

        def matvec(x):
            # the Krylov vector's halo exchanged at every application: the
            # reference's VecGhostUpdate inside each MatMult
            return mv(ex(x)) * mask

        def pcm(v):
            return pc(v) * mask

        if du0 is not None:
            x0 = du0.to(lrhs.dtype)
            x0 = torch.where(torch.isfinite(x0).all(), x0,
                             torch.zeros_like(x0))
        else:
            x0 = torch.zeros_like(lrhs)
        U = None
        if defl:
            du, iters, relres, U = gmres_dr(
                matvec, lrhs * mask, x0, pcm, U=U0, k=self.lin.deflation_k,
                restart=self.lin.restart, maxiter=self.lin.maxiter,
                rtol=rtol, allreduce=ar)
        else:
            du, iters, relres = gmres(
                matvec, lrhs * mask, x0, pcm, restart=self.lin.restart,
                maxiter=self.lin.maxiter, rtol=rtol, blocked=False,
                allreduce=ar)
        du = du.to(u.dtype)
        omega = self._update_factor(u, du, omega_cap)
        unew = u + omega[:, None] * du * mesh.cell_mask[:, None]

        loc = ((rhs[:, -1] ** 2) * mesh.area * mesh.cell_mask).sum()
        ok = (torch.isfinite(rhs).all() & torch.isfinite(unew).all()
              & torch.isfinite(du).all() & bool(np.isfinite(relres)))
        ok = allreduce_min(comm, ok.to(torch.int32).reshape(1))
        res = torch.sqrt(ar(loc))
        res = float(res) if int(ok) else float("nan")
        if return_carry:
            return unew, res, iters, du, U
        return unew, res, iters

    def _device_step(self, dmesh, u, cfl, rtol, omega_cap, lmesh=None,
                     bl=None, ctl=EAGER, ws=None):
        """The device form of _step on this rank's slab, the twin of
        SteadyBackwardEuler._device_step with _step's distributed parts:
        u halo-exchanged, the operators with the exchange and the sum over
        the ranks, the Krylov vector exchanged at every matvec,
        gmres_device with every inner product reduced, the update with the
        positivity line search, and res = sqrt(the reduced sum), NaN unless
        `ok` (the residual, state, update and relres finite) holds on every
        rank (allreduce_min). cfl, rtol and omega_cap are 0-dim tensors on
        u's device; no warm start (the device modes a distributed solve
        runs take none). Reads nothing back: returns (unew, res, iters, du)
        as device tensors, res and iters the same on every rank."""
        comm = self.flow.comm
        mesh = dmesh.mesh
        ex = partial(halo_exchange, dmesh.exch)
        ar = partial(allreduce_sum, comm)
        u = ex(u)
        rhs, lrhs, ops = self.step_operators(
            mesh, u, cfl, None if lmesh is None else lmesh.mesh, bl,
            exchange=ex, allreduce=ar)
        mv, pc = self._linear_operators(ops)
        mask = mesh.cell_mask[:, None].to(lrhs.dtype)
        du, iters, relres = gmres_device(
            lambda x: mv(ex(x)) * mask, lrhs * mask, torch.zeros_like(lrhs),
            lambda v: pc(v) * mask, rtol, restart=self.lin.restart,
            maxiter=self.lin.maxiter, blocked=False,
            ws=ws or self._workspace(u), ctl=ctl, allreduce=ar)
        du = du.to(u.dtype)
        omega = self._update_factor(u, du, omega_cap)
        unew = u + omega[:, None] * du * mesh.cell_mask[:, None]

        loc = ((rhs[:, -1] ** 2) * mesh.area * mesh.cell_mask).sum()
        ok = (torch.isfinite(rhs).all() & torch.isfinite(unew).all()
              & torch.isfinite(du).all() & torch.isfinite(relres))
        ok = allreduce_min(comm, ok.to(torch.int32).reshape(1))
        res = torch.where(ok.reshape(()) > 0, torch.sqrt(ar(loc)),
                          torch.full((), float("nan"), dtype=rhs.dtype,
                                     device=rhs.device))
        return unew, res, iters, du
