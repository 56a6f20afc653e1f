"""Device-resident implicit stepping: the implicit step as one device
program, and the three options of PseudoTimeConfig built on it.

In the JAX package a whole implicit step is one XLA program (its FGMRES a
lax.while_loop), and three options rest on that: `bake_mesh` closes the
mesh over the program, `device_steps = K` runs K steps with the
controller inside one program (lax.scan over lax.cond), and `pipeline`
queues step k+1 before reading step k's residual
(fvens_tpu/solver/steady.py:486-710). The port's counterpart of that
program is the device-form step, SteadyBackwardEuler._device_step: the
step with the device-controlled gmres (solver/linear.py:gmres_device) and
the NaN poisoning on the device, taking cfl, rtol and omega_cap as device
scalars and returning the residual, the Krylov iterations and the update
as device tensors, so that nothing is read back inside it. On a rank of a
distributed solve it is DistributedBackwardEuler._device_step
(dist/shard.py), its reductions inside: over NCCL they are captured with
the step, inside the IF nodes' bodies on one rank; over two or more the
step is captured masked (no IF nodes: NCCL's kernels may not sit in an IF
node's body), every Krylov iteration run and selected.

  - StepProgram: the device-form step on one (mesh, dtype). On the card it
    is captured once as a torch.cuda.CUDAGraph (each Krylov iteration, the
    blocked path's second pass and each restart cycle inside a CUDA-graph
    IF node: graph_if.GraphControl; the iterations in groups, each decided
    by the Givens update before it) and replayed per call, its inputs copied
    into static buffers first; elsewhere it runs eagerly, every branch
    computed and selected (linear.EAGER). It is bake_mesh's step and
    pipeline's.
  - ChunkProgram: K steps of the controller (controller_advance on device
    scalars through TorchXP) and the device-form step, each step inside an
    IF node on flag == 0 (the compare-and-set kernel), with the JAX
    package's per-step flags (1 converged, 2 non-finite or blowup, 3 four
    frozen residuals) and best state, writing each step's (res, cfl, flag,
    iterations) into a device buffer that the host reads once per chunk.
  - pipeline_burst: the twin of the JAX package's _pipeline_burst: the
    controller and step k+1 are queued before step k's scalars are read
    (two steps in flight), the anomaly and convergence checks run one step
    behind, and a speculative step is discarded on an anomaly or on
    convergence.

On the card every burst, chunk and baked step is queued under
torch.cuda.set_sync_debug_mode("error") (no_host_sync), so that any host
read inside it raises; the host reads only behind CUDA events, from pinned
memory (Readback), between steps. Everything a capture needs is made
before it: the kernels' builds, the solver's per-mesh structures, the f32
mesh and the TF32 switch come from an eager warm-up run on a side stream,
and the Krylov workspace (linear.KrylovWorkspace) is allocated once and
shared by the K steps of a chunk. The programs hold their workspace and
buffers, which the graphs write at every replay.
"""

from __future__ import annotations

import contextlib
import time

import torch

from ..io_config import logs
from . import device_counts
from .graph_if import ZERO, GraphControl
from .linear import EAGER, _sel


class TorchXP:
    """The NumPy functions controller_advance calls, on 0-dim tensors of
    one dtype on one device: the controller's arithmetic on the device
    without a host read (the JAX package evaluates it with xp=jnp)."""

    def __init__(self, dtype, device):
        self.dtype, self.device = dtype, device

    def _t(self, x):
        if torch.is_tensor(x):
            return x
        return torch.full((), x, dtype=self.dtype, device=self.device)

    def where(self, cond, a, b):
        return torch.where(cond, self._t(a), self._t(b))

    def minimum(self, a, b):
        return torch.minimum(self._t(a), self._t(b))

    def maximum(self, a, b):
        return torch.maximum(self._t(a), self._t(b))

    def clip(self, x, lo, hi):
        return self.minimum(self.maximum(x, lo), hi)


@contextlib.contextmanager
def no_host_sync(device):
    """On a CUDA device: any synchronizing host read inside raises
    (torch.cuda.set_sync_debug_mode("error")); elsewhere nothing."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class Readback:
    """Device tensors' values copied, as f64 and flattened in order, to
    pinned host memory behind a CUDA event when they are queued; get()
    waits for the event and returns them as floats. The copy is queued
    without a synchronizing call; on the CPU the values are read
    directly."""

    def __init__(self, tensors):
        v = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
        self.event = None
        if v.is_cuda:
            self.host = torch.empty(v.shape, dtype=torch.float64,
                                    pin_memory=True)
            self.host.copy_(v, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = v

    def get(self) -> list:
        logs.count("host_syncs")
        if self.event is not None:
            self.event.synchronize()
        return self.host.tolist()


def _fill(buf, value):
    """buf = value: a tensor is copied on the device, a number is filled."""
    if torch.is_tensor(value):
        buf.copy_(value.reshape(buf.shape))
    else:
        buf.fill_(value)


def capture_graph(device, body, masked: bool = False):
    """(graph, memory pool, outputs): `body(ctl)` captured into a new
    torch.cuda.CUDAGraph on `device`, its guarded parts as IF nodes
    (ctl a graph_if.GraphControl), or with `masked` as masked branches
    (ctl linear.EAGER: every branch captured and run, its writes
    selected; the graph holds no IF node). The capture stream allocates
    from the graph's own pool; the IF nodes' body streams, which the
    graph's pool does not see, from a second pool (all this thread's
    allocations that the first does not take), which lives as long as the
    caller keeps it."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ctl = EAGER if masked else GraphControl(device)
    pool = torch.cuda.MemPool()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        with torch.cuda.use_mem_pool(pool, device):
            outputs = body(ctl)
    return graph, pool, outputs


class _Captured:
    """A program body run eagerly or, on the card, captured once as a CUDA
    graph after an eager warm-up on a side stream. `body(ctl)` reads the
    program's input buffers and returns its outputs."""

    def __init__(self, device, masked: bool = False):
        self.device = torch.device(device)
        self.masked = masked    # capture_graph's: no IF nodes
        self.graph = None
        self.outputs = None
        self.capture_s = 0.0    # the warm-up's and the capture's seconds

    def run(self, body, prepare, warm=None):
        """Run the body once from the inputs `prepare()` writes: eagerly
        off the card; on the card the graph, captured at the first call
        (the warm-up, `warm` or else the body, which may read back as it
        builds and caches, and the capture run with the sync check off;
        prepare() again after the warm-up, which may have written the
        inputs)."""
        prepare()
        if self.device.type != "cuda":
            return body(EAGER)
        if self.graph is None:
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            t0 = time.perf_counter()
            try:
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side), device_counts.paused():
                    (warm or body)(EAGER)   # builds, caches, workspaces
                torch.cuda.current_stream(self.device).wait_stream(side)
                self.graph, self.pool, self.outputs = capture_graph(
                    self.device, body, self.masked)
                torch.cuda.synchronize(self.device)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                self.capture_s += time.perf_counter() - t0
            prepare()
        with logs.span("graph.replay"):
            self.graph.replay()
        return self.outputs


class StepProgram:
    """The device-form step of `solver` on one mesh and state dtype (the
    classic step: no warm start, no deflation), with the mesh, its f32
    copy and the per-mesh structures closed over it, as the JAX package
    closes them over its baked program. Call it with the state and cfl,
    rtol, omega_cap (numbers or 0-dim tensors on the card); it returns
    (unew, res, iters) as new device tensors."""

    def __init__(self, solver, mesh, lmesh, bl, u):
        self.solver, self.mesh, self.lmesh, self.bl = solver, mesh, lmesh, bl
        dev = u.device
        self.u = torch.empty_like(u)
        self.cfl, self.rtol, self.omega_cap = (
            torch.zeros((), dtype=torch.float64, device=dev)
            for _ in range(3))
        self.ws = solver._workspace(u)
        self.program = _Captured(dev, solver._masked_capture())

    def _body(self, ctl):
        s = self.solver
        unew, res, iters, _ = s._device_step(
            self.mesh, self.u, self.cfl, self.rtol, self.omega_cap,
            lmesh=self.lmesh, bl=self.bl, ctl=ctl, ws=self.ws)
        return unew, res, iters

    def __call__(self, u, cfl, rtol, omega_cap=1.0):
        def prepare():
            self.u.copy_(u)
            _fill(self.cfl, cfl)
            _fill(self.rtol, rtol)
            _fill(self.omega_cap, omega_cap)
        return tuple(t.clone() for t in self.program.run(self._body,
                                                         prepare))


# the chunk's carried state: the state, direction and best state (the
# state's shape and dtype), the float scalars (the state's dtype) and the
# int32 scalars
_CHUNK_FIELDS = ("u", "du", "u_best")
_CHUNK_FLOATS = ("res_best", "cfl", "cfl_cap", "rtol", "rtol_floor",
                 "raise_relres", "res", "resold", "initres")
_CHUNK_INTS = ("stall", "flag", "iters", "nsteps")


class ChunkProgram:
    """K implicit steps with the controller on the device, the twin of the
    JAX package's _chunk (lax.scan over lax.cond(flag != 0, id, live)):
    on the card one CUDA graph of K step bodies, each in an IF node on
    flag == 0, sharing one Krylov workspace. run() takes the host loop's
    state and returns (carry, outs): carry a dict of the _CHUNK_FIELDS as
    device tensors and of the scalars as host numbers, read back once;
    outs the per-step (res, cfl, flag, iterations) rows of the steps run."""

    def __init__(self, solver, K: int, mesh, lmesh, bl, u):
        self.solver, self.K = solver, K
        self.mesh, self.lmesh, self.bl = mesh, lmesh, bl
        dev, sd = u.device, u.dtype
        self.sd = sd
        self.b = {k: torch.zeros_like(u) for k in _CHUNK_FIELDS}
        self.b.update({k: torch.zeros((), dtype=sd, device=dev)
                       for k in _CHUNK_FLOATS})
        self.b.update({k: torch.zeros((), dtype=torch.int32, device=dev)
                       for k in _CHUNK_INTS})
        self.outs = torch.zeros((K, 4), dtype=torch.float64, device=dev)
        self.one = torch.ones((), dtype=torch.float64, device=dev)
        self.xp = TorchXP(sd, dev)
        self.ws = solver._workspace(u)
        self.program = _Captured(dev, solver._masked_capture())

    def _bodies(self, ctl):
        for i in range(self.K):
            ctl.run_if_cmp(ZERO, self.b["flag"], None, lambda pred, i=i:
                           self._body(i, ctl, pred))
        return ()

    def _body(self, i, ctl, pred):
        """Step i of the chunk: the JAX package's `live` (steady.py:
        504-548), its writes selected by `pred` (None: inside its node)."""
        s, b = self.solver, self.b
        cfg, lin = s.cfg, s.lin
        from .steady import controller_advance
        ctrl = controller_advance(cfg, lin, self.xp, b["cfl"], b["cfl_cap"],
                                  b["rtol"], b["rtol_floor"],
                                  b["raise_relres"], b["res"], b["resold"],
                                  b["initres"])
        u, initres, res = b["u"], b["initres"], b["res"]
        u_new, resj, itj, du_new = s._device_step(
            self.mesh, u, ctrl[0], ctrl[2], self.one, lmesh=self.lmesh,
            bl=self.bl, du0=b["du"] if s.lin.warm_start else None, ctl=ctl,
            ws=self.ws)
        resj = resj.to(self.sd)
        finite = torch.isfinite(resj)
        blown = finite & (resj > cfg.blowup_relres * initres)
        healthy = finite & ~blown
        improved = healthy & (resj < b["res_best"])
        frozen = (healthy & (torch.abs(resj / res - 1.0) < 1e-12)
                  & (resj / initres > cfg.tol))
        stall = torch.where(frozen, b["stall"] + 1, 0).to(torch.int32)
        done = healthy & (resj / initres <= cfg.tol)
        if cfg.tol_abs:
            done = done | (healthy & (resj <= cfg.tol_abs))
        flag = torch.where(~healthy, 2, torch.where(
            done, 1, torch.where(stall >= 4, 3, 0))).to(torch.int32)
        new = dict(
            u_best=torch.where(improved, u, b["u_best"]),
            res_best=torch.where(improved, resj, b["res_best"]),
            u=torch.where(healthy, u_new, u),
            du=torch.where(healthy, du_new, torch.zeros_like(du_new)),
            resold=torch.where(healthy, res, b["resold"]),
            res=resj, stall=stall, flag=flag,
            iters=(b["iters"] + itj).to(torch.int32),
            nsteps=b["nsteps"] + 1,
            **dict(zip(("cfl", "cfl_cap", "rtol", "rtol_floor",
                        "raise_relres"), ctrl)))
        row = torch.stack([resj.to(torch.float64),
                           ctrl[0].to(torch.float64),
                           flag.to(torch.float64), itj.to(torch.float64)])
        self.outs[i] = _sel(pred, row, self.outs[i])
        for k, v in new.items():
            b[k].copy_(_sel(pred, v.to(b[k].dtype), b[k]))

    def run(self, u, du, u_best, **scalars):
        """One chunk from the host loop's state (`scalars`: the
        _CHUNK_FLOATS and `stall`)."""
        b = self.b

        def prepare():
            b["u"].copy_(u)
            b["du"].copy_(du)
            b["u_best"].copy_(u_best)
            for k, v in scalars.items():
                _fill(b[k], v)
            for k in ("flag", "iters", "nsteps"):
                b[k].zero_()
        names = _CHUNK_FLOATS + _CHUNK_INTS
        with no_host_sync(u.device):
            # one step warms what K do: the bodies are the same step
            self.program.run(self._bodies, prepare, warm=lambda ctl:
                             self._body(0, ctl, self.b["flag"] == 0))
            rb = Readback([b[k] for k in names] + [self.outs])
        vals = rb.get()
        carry = dict(zip(names, vals))
        for k in _CHUNK_INTS:
            carry[k] = int(carry[k])
        for k in _CHUNK_FIELDS:
            carry[k] = b[k].clone()
        n = carry["nsteps"]
        rows = [vals[len(names) + 4 * i:len(names) + 4 * i + 4]
                for i in range(n)]
        return carry, rows


def pipeline_burst(solver, program: StepProgram, K: int, u, u_best,
                   res_best, stall, cfl, cfl_cap, rtol, rtol_floor,
                   raise_relres, res, resold, initres):
    """Up to K pipelined steps, the twin of the JAX package's
    _pipeline_burst (steady.py:562-668): the controller (on device
    scalars) and the step are queued for step k+1 before step k's
    residual and iterations are read; the checks run on the read scalars
    one step behind, and the step in flight is discarded on an anomaly or
    on convergence. Returns (carry, rows): carry as ChunkProgram.run's
    (u, u_best; res_best, stall, the controller, res, resold, flag, iters,
    nsteps) and the discarded steps' Readbacks of (res, iterations), rows
    the committed steps' (res, cfl, 0, iterations)."""
    cfg, lin = solver.cfg, solver.lin
    dev, sd = u.device, u.dtype
    xp = TorchXP(sd, dev)
    from .steady import controller_advance

    def f(x):
        return torch.full((), x, dtype=sd, device=dev)
    ctrl = tuple(f(x) for x in (cfl, cfl_cap, rtol, rtol_floor,
                                raise_relres))
    res_d, resold_d, init_d = f(res), f(resold), f(initres)
    initres_h = float(initres)
    u_cur = u
    inflight = []            # (u_prev, u_next, Readback of (res, iters), ctrl)
    rows, cfls = [], []
    n_done = iters_total = flag = 0
    stall = int(stall)
    res_h, resold_h = float(res), float(resold)
    best_ref, best_val = u_best, float(res_best)
    dispatched = 0
    final_u = u
    rv = res_h
    last_ctrl = ctrl         # the controller of the last committed (or
    #                          anomalous) step, returned to the host
    while flag == 0 and (inflight or dispatched < K):
        with no_host_sync(dev):
            while dispatched < K and len(inflight) < 2:
                ctrl = controller_advance(cfg, lin, xp, *ctrl, res_d,
                                          resold_d, init_d)
                u_next, resj, itj = program(u_cur, ctrl[0], ctrl[2], 1.0)
                inflight.append((u_cur, u_next, Readback([resj, itj]),
                                 ctrl))
                resold_d, res_d = res_d, resj.to(sd)
                u_cur = u_next
                dispatched += 1
        u_prev_k, u_next_k, rb, ctrl_k = inflight.pop(0)
        rv, iv = rb.get()
        iters_total += int(iv)
        last_ctrl = ctrl_k
        finite = rv == rv and abs(rv) != float("inf")
        blown = finite and rv > cfg.blowup_relres * initres_h
        if not finite or blown:
            flag = 2
            break
        if rv < best_val:
            # the residual was evaluated at u_prev_k (pre-update state)
            best_ref, best_val = u_prev_k, rv
        frozen = (abs(rv / res_h - 1.0) < 1e-12
                  and rv / initres_h > cfg.tol)
        stall = stall + 1 if frozen else 0
        resold_h, res_h = res_h, rv
        n_done += 1
        rows.append([rv, None, 0.0, float(iv)])
        cfls.append(ctrl_k[0])
        final_u = u_next_k
        if (rv / initres_h <= cfg.tol
                or (cfg.tol_abs and rv <= cfg.tol_abs)):
            flag = 1
            break
        if stall >= 4:
            flag = 3
            break
    # one read for the exit controller state and the committed steps' CFLs
    vals = Readback(list(last_ctrl) + cfls).get()
    for r, c in zip(rows, vals[5:]):
        r[1] = c
    carry = dict(u=final_u, u_best=best_ref, res_best=best_val, stall=stall,
                 # the steps still in flight, discarded: their read-backs
                 discarded=[rb for _, _, rb, _ in inflight],
                 cfl=vals[0], cfl_cap=vals[1], rtol=vals[2],
                 rtol_floor=vals[3], raise_relres=vals[4],
                 # on an anomaly, as the single-step loop: res the bad
                 # value, resold the last committed residual
                 res=res_h if flag != 2 else rv,
                 resold=resold_h if flag != 2 else res_h,
                 flag=flag, iters=iters_total, nsteps=n_done)
    return carry, rows
