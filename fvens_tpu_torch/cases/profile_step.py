"""Where one implicit step of a solve spends its time.

    python -m fvens_tpu_torch.cases.profile_step \
        [--case bench|cylinder|cylinder-gather|rowset|slot-gather|kernels
                |bsgs-v1|slot-kernel]
        [--pc bsgs|bcsgs|ilu0|amg|bline|mf-jvp|mf-fd|bsgs-recycle]
        [--device cuda|cpu]

`bench` (the default) is the bench solve of cases/bench_case.py on its
naca0012_omesh(160, 80); `cylinder` is the main solve of
cases/bigmesh_case.py on its 640x320 mesh, after the first-order starter;
`cylinder-gather` the same on the gather path (GATHER_BSGS, or with
`--pc` another preconditioner or solver option: bcsgs, GATHER_BCSGS, or a
preset of bigmesh_case.OPTIONS), whose matvec and preconditioner are plain
PyTorch, so it runs once; with a matrix-free preset the matvec is the
JVP or FD product, and with bsgs-recycle GMRES is also timed as gmres_dr,
first without and then with a recycled space. `rowset` times the row_set kernel alone
(rowset_profile); `slot-gather` the gather path's slot gather alone, on
the card or (`--device cpu`) on the CPU (slot_gather_profile). `kernels`
times the three kernels on their main-path operators, in two rounds
(kernel_times); `bsgs-v1` the bsgs apply at 1x1 blocks in each of its
designs on the heat equation's operators at 256x256 and 512x512, and a
phase's fixed cost in each (bsgs_v1_times); `slot-kernel` the gather
path's slot kernel in both roles on the 640x320 NACA0012 O-mesh's
operators beside its twin and the formula it replaced
(slot_kernel_times). The others
run WARM_STEPS steps, once through the CUDA
kernels and once through the plain banded twins (pallas=False; blocked
GMRES's basis appends stay the row_set kernel, which, as in the JAX
package, no option turns off), then at that state:

  1. times each phase of one step with the host clock around work that
     ends in a device synchronisation, median of 5 (GMRES and the step:
     of 3): the residual, the Jacobian with its pseudo-time term, the
     operator build (banded: the band blocks; gather: the slot operands
     and the preconditioner's set-up, make_bsr_matvec and
     make_preconditioner), one matvec, one preconditioner apply (on the
     gather path also the matvec's slot gather four ways, device time), the
     GMRES
     solve and the whole step. Where gmres runs blocked, also one blocked
     MGS pass over the mean number of filled basis rows of that solve,
     one basis append (row_set) and one host copy of two norms, median
     of 20. Through the kernels it also times the preconditioner apply
     three ways, in turns: the fused bsgs kernel (the solver's), the
     seven-launch banded_apply sequence and the plain twin; each by the
     host clock per call, and the kernels by their device time per apply
     (device_ms: applies queued back to back behind a device-side sleep,
     between CUDA events); the fused kernel (the solver's plan, and others
     of its shared memory: BSGS_VARIANTS) and the
     sequence sweep by sweep (device time at one sweep and at the solver's
     count: the first sweep with D^-1 v, and a later sweep as the
     difference over the rest), and the fixed cost of a phase
     (bsgs_phase_cost); and the whole step with the fused apply and with
     the sequence, in turns;
  2. traces one step with torch.profiler and prints the device time by
     kernel and the device's busy time (the sum over device events, so
     the operators that launched them are not counted twice) against the
     traced wall time.

Each prints one JSON line ("phases", "trace"). `profile()` also runs on
CPU tensors, where it measures host time only.
"""

from __future__ import annotations

import functools
import json
import time

import torch

from ..solver import banded_kernels as bk
from ..solver import jacobian as jacmod
from ..solver import linear
from ..solver import rowset_kernels as rk
from ..solver.banded import make_banded_bsgs
from ..solver.linear import gmres, gmres_dr
from ..solver.steady import banded_operators
from . import bigmesh_case
from . import model_problems as mp
from .bench_case import BENCH_MESH, bench_solver
from .casesolvers import build_space, initial_state

# past the first transient (bench: CFL ~60, 13 Krylov iterations with the
# kernel; cylinder: CFL ~1,860, 56 iterations)
WARM_STEPS = 20
MESHES = {"bench": BENCH_MESH, "cylinder": bigmesh_case.BIGMESH,
          "cylinder-gather": bigmesh_case.BIGMESH}
GATHER = dict({"bsgs": bigmesh_case.GATHER_BSGS,
                "bcsgs": bigmesh_case.GATHER_BCSGS}, **bigmesh_case.OPTIONS)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sync_ms(dev, fn, reps=5):
    """(median host ms of fn() over `reps` synchronised calls, its result),
    after one warm-up call."""
    out = fn()
    _sync(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2] * 1e3, out


def device_ms(fn, n=50):
    """Device time per call of fn() in ms: n calls queued behind a
    device-side sleep that outlasts their enqueueing, so that they run back
    to back, timed by CUDA events around them. Raises if the sleep ended
    before the host had queued them all, three times over."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    # a sleep of about twice that, at ~2 GHz, and at least 10 ms
    cycles = int(max((time.perf_counter() - t0) * 4e9, 2e7))
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        slept_ms = ev[0].elapsed_time(ev[1])
        if queued_ms < slept_ms:
            return ev[1].elapsed_time(ev[2]) / n
        cycles *= 4
    raise RuntimeError(f"device_ms: the host took {queued_ms:.3f} ms to queue "
                       f"{n} calls behind a {slept_ms:.3f} ms device sleep: "
                       "the calls wait for the device")


def _device_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def _on_device(e):
    return e.device_type == torch.autograd.DeviceType.CUDA


def _warm_state(dev, case: str, mesh, warm: int, pallas: bool, lin: dict):
    """(main solver, mesh, state after `warm` main steps, SolveInfo)."""
    if case == "bench":
        solver, cm = bench_solver(dev, mesh=mesh, pallas=pallas)
        u = initial_state(solver.space, cm)
    else:
        fcase, cm, u = bigmesh_case.build_case(dev, *mesh, pallas=pallas,
                                               **lin)
        u = fcase.execute_starter(cm, u)
        solver = fcase._make_solver(build_space(fcase.cfg), fcase.cfg.main)
    u, info = solver.solve(cm, u, max_steps=warm)
    return solver, cm, u, info


def _sequence_operators(solver):
    """A solver's _linear_operators with the seven-launch banded_apply
    sequence as the preconditioner."""
    base = type(solver)._linear_operators

    def ops_fn(ops):
        mv, _ = base(solver, ops)
        return mv, _make_pc(solver, ops, "sequence")
    return ops_fn


def _make_pc(solver, ops, name: str):
    sweeps, offs = solver.lin.pc_sweeps, ops.bl.offsets
    if name == "fused":
        return bk.make_banded_bsgs_kernel(ops.Dinv, ops.DNbt, offs, sweeps,
                                          ops.bl.support)
    if name == "sequence":
        return bk.make_banded_bsgs_sequence(ops.Dinv, ops.DNbt, offs, sweeps)
    return make_banded_bsgs(ops.Dinv, ops.DNbt, offs, sweeps)


def _pc_variants(dev, solver, ops, v):
    """The pc apply three ways, in turns (fused, sequence, twin, then
    back): host ms per call and, but for the twin, device ms per apply,
    both rounds; then the kernels sweep by sweep."""
    rec = {}
    names = ("fused", "sequence", "twin")
    for order in (names, names[::-1]):
        for name in order:
            pc = _make_pc(solver, ops, name)
            host, _ = sync_ms(dev, lambda: pc(v), 50)
            rec.setdefault(f"pc_{name}_ms", []).append(host)
            if name != "twin":     # ~200 launches a call: more than the
                rec.setdefault(    # device queue holds behind a sleep
                    f"pc_{name}_device_ms", []).append(device_ms(lambda: pc(v)))
    rec["pc_sweeps"] = _pc_sweep_times(solver, ops, v)
    rec["pc_phase_cost"] = bsgs_phase_cost(dev)
    return rec


def _pc_sweep_times(solver, ops, v):
    """bsgs_phase_times on the step's operators at the solver's sweeps."""
    (dinv, _), (dn, dms) = bk.bsgs_bands(ops.Dinv, ops.DNbt, ops.bl.offsets)
    return bsgs_phase_times(dinv, dn, dms, ops.bl.support,
                            solver.lin.pc_sweeps, v)


# the fused kernel with the solver's plan, and with other shared memory per
# block: by name, the BsgsApply keywords as a function of the card's
# bsgs_device_limits
BSGS_VARIANTS = {
    "fused": lambda lim: {},
    "no_l1_room": lambda lim: dict(smem_bytes=lim["smem_optin"]),
    "shared_tier": lambda lim: dict(smem_bytes=lim["smem_per_block"]),
    "none_resident": lambda lim: dict(smem_bytes=0),
}


def bsgs_phase_times(dinv, dn, dms, support, S: int, v,
                     variants=tuple(BSGS_VARIANTS)) -> dict:
    """Device ms of the fused kernel in each of `variants` (BSGS_VARIANTS)
    and of the seven-launch sequence, at one sweep and at S: the first
    sweep with D^-1 v (first_ms), the whole apply (total_ms) and a later
    sweep, (t_S - t_1) / (S - 1). Each fused result is held equal to the
    sequence's. The variants run in turns, then again in reverse order;
    each number is the lower of the two rounds."""
    seq = {s: bk.bsgs_sequence(dinv, dn, dms, s) for s in (1, S)}
    lim = bk.bsgs_device_limits(v.device)
    apps = {name: {s: bk.BsgsApply(dinv, dn, dms, s, support,
                                   **BSGS_VARIANTS[name](lim))
                   for s in (1, S)}
            for name in variants}
    apps["sequence"] = seq
    rec = {}
    for order in (list(apps), list(apps)[::-1]):
        for name in order:
            t = {}
            for s in (1, S):
                app = apps[name][s]
                if name != "sequence" and not torch.equal(app(v), seq[s](v)):
                    raise RuntimeError(f"{name} differs from the sequence")
                t[s] = device_ms(lambda: app(v))
            r = dict(first_ms=t[1], total_ms=t[S],
                     later_sweep_ms=(t[S] - t[1]) / max(S - 1, 1))
            old = rec.get(name)
            rec[name] = r if old is None else {
                k: min(old[k], r[k]) for k in r}
    for name in variants:
        p = apps[name][S].plan
        rec[name].update(n_res=p.n_res, chunk=p.chunk)
    return rec


def bsgs_phase_cost(dev, dtype=torch.float32, S: int = 6) -> dict:
    """The fixed cost of a phase of the fused kernel, where its data is
    negligible: one 16-byte run of cells per block on every SM (528 cells
    at f32), six full bands; device ms per phase, (t_S - t_0) / S, and
    the sequence's per launch."""
    sms = bk.bsgs_device_limits(dev)["n_blocks"]
    NC = sms * bk.bsgs_align(dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    dinv = torch.randn(1, 4, 4, NC, device=dev, dtype=dtype, generator=g)
    dn = torch.randn(6, 4, 4, NC, device=dev, dtype=dtype, generator=g) / 48
    dms = (-1, 1, -17, 17, 101, -101)
    v = torch.randn(NC, 4, device=dev, dtype=dtype, generator=g)
    t = {s: device_ms(lambda a=bk.BsgsApply(dinv, dn, dms, s): a(v))
         for s in (0, S)}
    rec = dict(NC=NC, blocks=sms, phase_ms=(t[S] - t[0]) / S,
               apply_ms=t[S])
    rec["sequence_launch_ms"] = device_ms(
        lambda: bk.bsgs_sequence(dinv, dn, dms, S)(v)) / (S + 1)
    return rec


def bsgs_phase_cost_v1(dev, dtype=torch.float32, S: int = 6) -> dict:
    """bsgs_phase_cost at 1x1 blocks, for both designs of the apply: one
    16-byte run of cells per SM (528 cells at f32), four bands at shifts
    (-16, -1, 1, 16), each zero short of the wrap (as the heat equation's),
    so that the cluster design takes it. Per design, device ms per phase
    (t_S - t_0) / S: for the cooperative kernel a phase chained through
    flags in device memory, for the cluster kernel a sweep and its cluster
    barrier; and the sequence's per launch."""
    NC = bk.bsgs_device_limits(dev)["n_blocks"] * bk.bsgs_align(dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    dms = (-16, -1, 1, 16)
    support = tuple((max(0, -d), min(NC, NC - d)) for d in dms)
    dinv = torch.randn(1, 1, 1, NC, device=dev, dtype=dtype, generator=g)
    dn = torch.randn(4, 1, 1, NC, device=dev, dtype=dtype, generator=g) / 8
    for k, (lo, hi) in enumerate(support):
        dn[k, ..., :lo] = 0
        dn[k, ..., hi:] = 0
    v = torch.randn(NC, 1, device=dev, dtype=dtype, generator=g)
    rec = dict(NC=NC, V=1)
    for design in bk.DESIGNS:
        apps = {s: bk.BsgsApply(dinv, dn, dms, s, support, design=design)
                for s in (0, S)}
        t = {s: device_ms(lambda a=apps[s]: a(v)) for s in (0, S)}
        rec[design] = dict(phase_ms=(t[S] - t[0]) / S, apply_ms=t[S],
                           zero_sweeps_ms=t[0])
        p = apps[S].plan
        rec[design].update(
            dict(cluster=p.cluster, clusters=p.clusters, slice=p.slice)
            if design == "cluster" else dict(blocks=p.blocks))
    rec["sequence_launch_ms"] = device_ms(
        lambda: bk.bsgs_sequence(dinv, dn, dms, S)(v)) / (S + 1)
    return rec


def heat_bsgs_operands(dev, n: int, dtype):
    """(dinv, dn, shifts, supports, sweeps) of the banded heat equation's
    bsgs x6 apply on unit_square(n) at step 0 (f32: its mixed-precision
    Krylov system)."""
    solver, mesh = mp.heat_solver(dev, n, False, banded=True, pc="bsgs",
                                  pc_sweeps=6,
                                  mixed_precision=dtype == torch.float32)
    u0 = torch.zeros((mesh.NC, 1), dtype=torch.float64, device=dev)
    _, _, ops = solver.step_operators(mesh, u0, solver.cfg.cfl_init)
    (dinv, _), (dn, dms) = bk.bsgs_bands(ops.Dinv, ops.DNbt, ops.bl.offsets)
    return dinv, dn, dms, tuple(ops.bl.support), solver.lin.pc_sweeps


# the bsgs apply at 1x1 blocks: by name, the BsgsApply keywords
BSGS_V1_DESIGNS = {"cooperative": dict(design="cooperative"),
                   "cluster": {}, "cluster 16": dict(cluster=16),
                   "cluster 4": dict(cluster=4)}


def bsgs_v1_times(dev, sizes=(256, 512)):
    """Device ms (device_ms) of the bsgs apply at 1x1 blocks on the heat
    equation's step-0 operators at each n of `sizes`, f32 and f64, in each
    design of BSGS_V1_DESIGNS that has a plan (clusters of 4 do not fit
    512x512 at f64) and in the seven-launch
    sequence, in turns and again in reverse order (each number the lower
    of the two rounds), every apply held equal to the sequence; with the
    bound (bytes at 3.35 TB/s). Prints one "bsgs v1" JSON line each."""
    limits = bk.bsgs_cluster_limits(dev)
    for n in sizes:
        for dtype in (torch.float32, torch.float64):
            dinv, dn, dms, support, S = heat_bsgs_operands(dev, n, dtype)
            g = torch.Generator(device=dev).manual_seed(n)
            v = torch.randn(n * n, 1, device=dev, dtype=dtype, generator=g)
            seq = bk.bsgs_sequence(dinv, dn, dms, S)
            want = seq(v)
            fns, rec = {}, dict(n=n, NC=n * n, dtype=str(dtype)[6:],
                                sweeps=S, card=torch.cuda.get_device_name(dev),
                                max_clusters=limits["max_clusters"])
            for name, kw in BSGS_V1_DESIGNS.items():
                if "cluster" in kw and bk.bsgs_cluster_plan(
                        n * n, dms, support, S, dtype, limits,
                        kw["cluster"]) is None:
                    rec[f"{name} plan"] = "none: the card does not take it"
                    continue
                app = bk.BsgsApply(dinv, dn, dms, S, support, **kw)
                if not torch.equal(app(v), want):
                    raise RuntimeError(f"{name} differs from the sequence")
                fns[name] = lambda a=app: a(v)
                p = app.plan
                rec[f"{name} plan"] = (
                    dict(cluster=p.cluster, clusters=p.clusters,
                         owned=p.owned, slice=p.slice,
                         smem_bytes=p.smem_bytes)
                    if app.design == "cluster" else
                    dict(blocks=p.blocks, chunk=p.chunk, n_res=p.n_res))
            fns["sequence"] = lambda: seq(v)
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    t = device_ms(fns[name])
                    rec[f"{name} ms"] = min(rec.get(f"{name} ms", t), t)
            # each band over its support, D^-1, v and the output once
            rec["bound_bytes"] = (sum(hi - lo for lo, hi in support)
                                  + 3 * n * n) * dn.element_size()
            rec["bound_ms"] = rec["bound_bytes"] / 3.35e12 * 1e3
            for name in fns:
                rec[f"{name} bound_share"] = rec["bound_ms"] / rec[
                    f"{name} ms"]
            print("bsgs v1", json.dumps(rec), flush=True)
    for dtype in (torch.float32, torch.float64):
        print("bsgs v1 phase cost", json.dumps(dict(
            dtype=str(dtype)[6:], **bsgs_phase_cost_v1(dev, dtype))),
            flush=True)


def _slot_gather_ways(mesh, x):
    """ms of the gather matvec's (NC, 5) slot gather of x, five ways in
    plain PyTorch, each held equal to x[idx]: x[idx], index_select of rows,
    gather with an expanded index, take of element indices and index_select
    of the same element indices from the flattened x (the solver's,
    linear._gather_rows). Device time on the card, the host's median of 20
    calls on the CPU."""
    NC, V = x.shape
    self_idx = torch.arange(NC, dtype=mesh.cell_nbrs.dtype, device=x.device)
    idx = torch.cat([self_idx[:, None], linear._nbrs_in_range(mesh)], dim=1)
    flat = idx.reshape(-1)
    expanded = flat[:, None].expand(-1, V)
    elems = linear._row_elements(idx, V)
    ways = {"index": lambda: x[idx],
            "index_select": lambda: torch.index_select(x, 0, flat),
            "gather_expanded": lambda: torch.gather(x, 0, expanded),
            "take": lambda: torch.take(x, elems),
            "flat_index_select": lambda: x.reshape(-1).index_select(0, elems)}
    want = x[idx]
    out = {}
    for name, fn in ways.items():
        if not torch.equal(fn().reshape(want.shape), want):
            raise RuntimeError(f"slot gather '{name}' differs from x[idx]")
        out[name] = (device_ms(fn) if x.is_cuda
                     else sync_ms(x.device, fn, 20)[0])
    return out


# the 640x320 solve's mesh, and the CPU tests' size
SLOT_GATHER_MESHES = {"cuda": ((640, 320), (32, 16)), "cpu": ((32, 16),)}


def slot_gather_profile(dev):
    """The slot gather's ways (_slot_gather_ways) on the cylinder_omesh
    meshes of SLOT_GATHER_MESHES, f32 and f64, on `dev`. Prints one "slot
    gather" JSON line each."""
    for ni, nj in SLOT_GATHER_MESHES[dev.type]:
        _, cm, _ = bigmesh_case.build_case(dev, ni, nj)
        g = torch.Generator(device=dev).manual_seed(0)
        for dtype in (torch.float32, torch.float64):
            x = torch.randn(cm.NC, 4, device=dev, dtype=dtype, generator=g)
            rec = dict(mesh=[ni, nj], cells=cm.n_cells, dtype=str(dtype)[6:],
                       device=dev.type, torch_threads=torch.get_num_threads(),
                       ms=_slot_gather_ways(cm, x))
            print("slot gather", json.dumps(rec), flush=True)


def profile(dev, mesh, warm: int, pallas: bool, case: str = "bench",
            pc: str = "bsgs"):
    """Phase times and a one-step trace of the `case` solve ("bench":
    naca0012_omesh `mesh`; "cylinder": cylinder_omesh `mesh`, main solve;
    "cylinder-gather": the same on the gather path with `pc`, GATHER[pc])
    after `warm` steps, through the kernels (`pallas`) or the twins."""
    gather = case == "cylinder-gather"
    lin = GATHER[pc] if gather else {}
    solver, cm, u, info = _warm_state(dev, case, mesh, warm, pallas, lin)
    cfl, rtol = info.history[-1][3], solver.lin.rtol
    bl = solver._banded(cm)
    mixed = solver.lin.mixed_precision
    lmesh = cm.to(torch.float32) if mixed else cm
    sp = solver.space
    rec = dict(case=case, mesh=list(mesh), pallas=pallas, warm_steps=warm,
               cfl=cfl, banded=bl is not None, pc=solver.lin.pc,
               pc_sweeps=solver.lin.pc_sweeps,
               option=pc if gather else None)
    rec["residual_ms"], (rhs, dt) = sync_ms(
        dev, lambda: sp.compute_residual(cm, u, True))
    kdt = torch.float32 if mixed else u.dtype
    lu, lrhs, ldt = u.to(kdt), rhs.to(kdt), dt.to(kdt)
    rec["jacobian_ms"], jac = sync_ms(dev, lambda: jacmod.add_pseudotime_term(
        lmesh, sp.assemble_jacobian(lmesh, lu), cfl, ldt))
    if gather:
        mf = (solver._matrix_free_matvec(cm, lmesh, u, lu, rhs, dt, ldt, cfl,
                                         kdt)
              if solver.lin.matrix_free else None)
        ops = solver._gather_operators(cm, lmesh, jac, mf)
        rec["operators_ms"], (mv, pc_fn) = sync_ms(
            dev, lambda: solver._linear_operators(ops))
    else:
        rec["operators_ms"], ops = sync_ms(
            dev, lambda: banded_operators(bl, jac))
        mv, pc_fn = solver._linear_operators(ops)
    rec["matvec_ms"], _ = sync_ms(dev, lambda: mv(lrhs), 50)
    rec["pc_ms"], _ = sync_ms(dev, lambda: pc_fn(lrhs), 50)
    if gather and dev.type == "cuda":
        rec["slot_gather_device_ms"] = _slot_gather_ways(lmesh, lrhs)
    if pallas and dev.type == "cuda" and not gather:
        rec.update(_pc_variants(dev, solver, ops, lrhs))
    rec["gmres_ms"], (_, its, _) = sync_ms(dev, lambda: gmres(
        mv, lrhs, torch.zeros_like(lrhs), pc_fn, restart=solver.lin.restart,
        maxiter=solver.lin.maxiter, rtol=rtol), 3)
    rec["gmres_iters"] = its
    rec["gmres_ms_per_iter"] = rec["gmres_ms"] / max(its, 1)
    if solver.lin.deflation_k:
        k = solver.lin.deflation_k
        U = None
        for key in ("gmres_dr_first", "gmres_dr_recycled"):
            rec[f"{key}_ms"], (_, its, _, U) = sync_ms(dev, lambda: gmres_dr(
                mv, lrhs, torch.zeros_like(lrhs), pc_fn, U=U, k=k,
                restart=solver.lin.restart, maxiter=solver.lin.maxiter,
                rtol=rtol), 3)
            rec[f"{key}_iters"] = its
    n = lrhs.numel()
    rec["blocked"] = n >= linear._BLOCKED_N_THRESHOLD
    if rec["blocked"]:
        # the basis work of one iteration at the solve's mean filled rows
        m = solver.lin.restart
        mpad = -(-(m + 1) // linear._ROW_BLOCK) * linear._ROW_BLOCK
        V = torch.randn(mpad, n, device=dev, dtype=lrhs.dtype)
        V = V / V.norm(dim=1, keepdim=True)
        w = lrhs.reshape(n)
        rows = min(m, its // 2 + 1)
        rec["mgs_rows"] = rows
        rec["mgs_pass_ms"], _ = sync_ms(
            dev, lambda: linear._mgs_pass(V, w, rows), 20)
        hn = linear._norm2(w)
        rec["row_set_ms"], _ = sync_ms(
            dev, lambda: rk.row_set(V, rows, w, hn), 20)
        # the second-pass decision's own host copy of the two norms
        rec["norm_fetch_ms"], _ = sync_ms(
            dev, lambda: torch.stack([hn, hn]).cpu(), 20)
    rec["step_ms"], _ = sync_ms(dev, lambda: solver._step(
        cm, u, cfl, rtol, lmesh=lmesh, bl=bl), 3)
    if pallas and dev.type == "cuda" and not gather:
        # the step with each pc, in turns (fused, sequence, then back),
        # median of 3 each
        for name in ("fused", "sequence", "sequence", "fused"):
            if name == "sequence":
                solver._linear_operators = _sequence_operators(solver)
            ms, _ = sync_ms(dev, lambda: solver._step(
                cm, u, cfl, rtol, lmesh=lmesh, bl=bl), 3)
            rec.setdefault(f"step_{name}_ms", []).append(ms)
            solver.__dict__.pop("_linear_operators", None)
    print("phases", json.dumps(rec), flush=True)

    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    n0, r0 = bk.banded_apply.launches, rk.row_set.launches
    f0 = bk.bsgs_apply.launches
    _sync(dev)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        solver._step(cm, u, cfl, rtol, lmesh=lmesh, bl=bl)
        _sync(dev)
    wall = time.perf_counter() - t0
    ka = sorted((e for e in prof.key_averages() if _on_device(e)),
                key=lambda e: -_device_us(e))
    print("trace", json.dumps(dict(
        case=case, pc=solver.lin.pc, pallas=pallas, traced_wall_ms=wall * 1e3,
        device_busy_ms=sum(_device_us(e) for e in ka) / 1e3,
        kernel_launches=bk.banded_apply.launches - n0,
        bsgs_launches=bk.bsgs_apply.launches - f0,
        row_set_launches=rk.row_set.launches - r0,
        top_device_ms=[(e.key[:60], e.count, _device_us(e) / 1e3)
                       for e in ka[:15]])), flush=True)


ROWSET_SIZES = (262_528, 819_200, 1_638_400)


def _host_us(fn, n=2000):
    """Host microseconds per call of fn() over n calls (then a sync)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def rowset_profile(dev):
    """row_set (K2) on a (96, n) basis, row 37, at ROWSET_SIZES, f32 and
    f64: device time per launch (device_ms) and call time (CUDA events
    around one call, median of 50); and at n = 819,200 f32 where the host
    time of a call goes: the checks, the stream lookup (the raw stream the
    wrapper reads, and torch.cuda.current_stream), the pointers, ctypes (a
    one-argument C call; the launcher with n = 0, which stops after
    cudaGetDevice), the launch, the whole wrapper. Prints one "row_set"
    JSON line each, and one "row_set host" line."""
    g = torch.Generator(device=dev).manual_seed(0)
    idx = dev.index
    for n in ROWSET_SIZES:
        for dtype in (torch.float32, torch.float64):
            V = torch.randn(96, n, device=dev, dtype=dtype, generator=g)
            w = torch.randn(n, device=dev, dtype=dtype, generator=g)
            hn = linear._norm2(w)
            rec = dict(n=n, dtype=str(dtype)[6:],
                       device_ms=device_ms(lambda: rk.row_set(V, 37, w, hn),
                                           n=200),
                       call_ms=_event_ms(lambda: rk.row_set(V, 37, w, hn)))
            print("row_set", json.dumps(rec), flush=True)
            if n != 819_200 or dtype != torch.float32:
                continue
            fn = rk._FNS[dtype]
            lib = rk._LIB[0]
            row = V.data_ptr() + 37 * V.stride(0) * V.element_size()
            args = (row, w.data_ptr(), hn.data_ptr())
            raw = torch._C._cuda_getCurrentRawStream
            stream = raw(idx)
            split = dict(
                check_us=_host_us(lambda: rk._check(V, 37, w, hn)),
                raw_stream_us=_host_us(lambda: raw(idx)),
                current_stream_us=_host_us(
                    lambda: torch.cuda.current_stream(idx).cuda_stream),
                pointers_us=_host_us(lambda: (
                    V.data_ptr() + 37 * V.stride(0) * V.element_size(),
                    w.data_ptr(), hn.data_ptr(), V.shape[1])),
                ctypes_one_arg_us=_host_us(
                    lambda: lib.fvens_row_set_error_string(0)),
                ctypes_get_device_us=_host_us(
                    lambda: fn(idx, *args, 0, rk.TINY, stream)),
                launch_us=_host_us(
                    lambda: fn(idx, *args, n, rk.TINY, stream)),
                row_set_us=_host_us(lambda: rk.row_set(V, 37, w, hn)))
            print("row_set host", json.dumps(split), flush=True)


def _event_ms(fn, runs=50):
    """Median CUDA-event time of one call of fn() in ms, after a warm-up."""
    fn()
    ts = []
    for _ in range(runs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        ev[1].synchronize()
        ts.append(ev[0].elapsed_time(ev[1]))
    ts.sort()
    return ts[len(ts) // 2]


def _step0_operators(dev, case: str, mixed: bool):
    """(solver, mesh, banded operators at the free stream) of the 640x320
    cylinder's main solve ("cylinder") or the bench solve ("bench"),
    mixed precision (f32 operators) or not (f64)."""
    import dataclasses

    from .casesolvers import SteadyFlowCase
    if case == "cylinder":
        c, cm, _ = bigmesh_case.build_case(dev, *bigmesh_case.BIGMESH)
        cfg = c.cfg
        if not mixed:
            cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
                cfg.linear, mixed_precision=False))
        solver = SteadyFlowCase(cfg)._make_solver(build_space(cfg), cfg.main)
    else:
        solver, cm = bench_solver(dev, mixed=mixed)
    _, _, ops = solver.step_operators(cm, initial_state(solver.space, cm),
                                      solver.cfg.cfl_init)
    return solver, cm, ops


def kernel_times(dev):
    """Device ms (device_ms) of K1 (the K=7 matvec), K1b (the fused bsgs
    apply, and the seven-launch sequence of K1) on the step-0 operators of
    the 640x320 cylinder (f32 and f64) and of the bench mesh (f32), and of
    K2 (row 37 of a (96, 819,200) f32 basis), in two rounds. Every fused
    apply is held equal to the sequence. Prints one "kernels" JSON line
    per operator set."""
    g = torch.Generator(device=dev).manual_seed(0)
    for case, mixed in (("cylinder", True), ("cylinder", False),
                        ("bench", True)):
        solver, cm, ops = _step0_operators(dev, case, mixed)
        S = solver.lin.pc_sweeps
        x = torch.randn(cm.NC, 4, device=dev, dtype=ops.D.dtype,
                        generator=g)
        bands7, d7 = bk.matvec_bands(ops.D, ops.Bt, ops.bl.offsets)
        (dinv, _), (dn, dms) = bk.bsgs_bands(ops.Dinv, ops.DNbt,
                                             ops.bl.offsets)
        mv = bk.BandedApply(bands7, d7)
        pc = bk.BsgsApply(dinv, dn, dms, S, ops.bl.support)
        seq = bk.bsgs_sequence(dinv, dn, dms, S)
        if not torch.equal(pc(x), seq(x)):
            raise RuntimeError("the fused apply differs from the sequence")
        fns = dict(matvec=lambda: mv(x), bsgs=lambda: pc(x),
                   sequence=lambda: seq(x))
        rec = dict(case=case, NC=cm.NC, dtype=str(ops.D.dtype)[6:],
                   sweeps=S, card=torch.cuda.get_device_name(dev))
        for _ in range(2):
            for kname, fn in fns.items():
                rec.setdefault(f"{kname} ms", []).append(device_ms(fn))
        print("kernels", json.dumps(rec), flush=True)
    V = torch.randn(96, 819_200, device=dev, generator=g)
    w = torch.randn(819_200, device=dev, generator=g)
    hn = linear._norm2(w)
    rec = dict(case="row_set", n=819_200, dtype="float32",
               row_set_ms=[device_ms(lambda: rk.row_set(V, 37, w, hn), n=200)
                           for _ in range(2)])
    print("kernels", json.dumps(rec), flush=True)


SLOT_MESH = (640, 320)          # naca0012_omesh: the NACA cell's mesh
SLOT_SWEEPS = 6
HBM_BYTES_PER_S = 3.35e12       # an H100 SXM's published bandwidth


def slot_operators(dev, dtype, mesh=SLOT_MESH):
    """(mesh, BlockJacobian) of the bench physics on the gather path at a
    perturbed free stream on naca0012_omesh(*mesh), at `dtype` (f32: the
    mixed-precision Krylov system)."""
    import numpy as np
    solver, cm = bench_solver(dev, mesh=mesh, banded=False,
                              mixed=dtype == torch.float32)
    u0 = initial_state(solver.space, cm)
    u0 = u0 * (1.0 + 0.01 * torch.from_numpy(
        np.random.default_rng(0).standard_normal(tuple(u0.shape))).to(dev))
    _, _, ops = solver.step_operators(cm, u0, 500.0)
    return ops.mesh, ops.jac


def _slot_formula(m, jac, sweeps):
    """(matvec, bsgs apply) as the solver ran them before the slot kernel:
    index_select of flat elements (linear._gather_rows), bmm, subtract."""
    NC, V = jac.D.shape[0], jac.D.shape[-1]
    self_idx = torch.arange(NC, dtype=m.cell_nbrs.dtype, device=jac.D.device)
    idx = torch.cat([self_idx[:, None], linear._nbrs_in_range(m)], dim=1)
    elems = linear._row_elements(idx, V)
    op = linear._slot_operand(torch.cat([jac.D[:, None], jac.N], dim=1))
    Dinv = linear.block_jacobi_inverse(jac.D)
    DN = linear._slot_operand(torch.einsum("cij,ckjl->ckil", Dinv, jac.N))
    nbrs = linear._nbrs_in_range(m)
    nelems = linear._row_elements(nbrs, V)

    def mv(x):
        return linear._slot_apply(op, linear._gather_rows(x, elems,
                                                          idx.shape))

    def pc(v):
        dv = torch.einsum("cij,cj->ci", Dinv, v)
        z = dv
        for _ in range(sweeps):
            z = dv - linear._slot_apply(DN, linear._gather_rows(
                z, nelems, nbrs.shape))
        return z
    return mv, pc


def slot_kernel_times(dev):
    """The slot kernel (solver/slot_kernels.py) in both roles on
    slot_operators at f32 and f64: device ms (device_ms) of the matvec and
    of the bsgs x SLOT_SWEEPS apply, of the apply at 0 and 1 sweeps, of the
    plain twin on the card and of the formula the solver ran before
    (`library_ms`: index_select and bmm), each held to the formula (the
    relative max difference), and the bound: each input read once and the
    output written once at HBM_BYTES_PER_S. Returns the rows; prints one
    "slot kernel" JSON line each."""
    from ..solver import slot_kernels as sk
    rows = []
    g = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        m, jac = slot_operators(dev, dtype)
        NC, V = jac.D.shape[0], jac.D.shape[-1]
        itemsize = jac.D.element_size()
        bound_ms = 1e3 * m.n_cells * itemsize * (5 * V * V + 2 * V) \
            / HBM_BYTES_PER_S
        x = torch.randn(NC, V, device=dev, dtype=dtype, generator=g)
        fmv, fpc = _slot_formula(m, jac, SLOT_SWEEPS)
        mv = linear.make_bsr_matvec(m, jac)
        for role, fn, want, twin in (
                ("matvec", mv, fmv,
                 lambda: sk.slot_matvec_plain(mv.op, mv.idx, x)),
                ("bsgs", None, fpc, None)):
            if role == "bsgs":
                fn = linear.make_preconditioner(m, jac, "bsgs", SLOT_SWEEPS)
                twin = functools.partial(sk.slot_bsgs_plain, fn.dinv, fn.op,
                                         fn.idx, SLOT_SWEEPS, x)
            ref = want(x)
            got = fn(x)
            torch.cuda.synchronize(dev)
            rec = dict(role=role, dtype=str(dtype)[6:], cells=m.n_cells,
                       NC=NC, sweeps=SLOT_SWEEPS if role == "bsgs" else None,
                       card=torch.cuda.get_device_name(dev),
                       rel_err=float((got - ref).abs().max()
                                     / ref.abs().max()),
                       bound_ms=bound_ms,
                       device_ms=device_ms(lambda: fn(x)),
                       plain_ms=_event_ms(twin, runs=20),
                       # 20 calls: the formula's bsgs apply is 20
                       # launches, and the launch queue holds about 1,000
                       library_ms=device_ms(lambda: want(x), n=20))
            rec["bound_share"] = bound_ms / rec["device_ms"]
            if role == "bsgs":
                for k in (0, 1):
                    pk = sk.SlotKernel(fn.op, fn.idx, dinv=fn.dinv, sweeps=k)
                    rec[f"device_ms_{k}_sweeps"] = device_ms(lambda: pk(x))
            print("slot kernel", json.dumps(rec), flush=True)
            rows.append(rec)
    return rows


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=sorted(MESHES) + [
        "rowset", "slot-gather", "kernels", "bsgs-v1", "slot-kernel"],
        default="bench")
    ap.add_argument("--pc", choices=sorted(GATHER), default="bsgs",
                    help="the preconditioner of --case cylinder-gather")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device of --case slot-gather")
    args = ap.parse_args()
    if args.case == "slot-gather":
        slot_gather_profile(torch.device(args.device))
        return
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(dev), flush=True)
    if args.case == "rowset":
        rk.load_library()
        rowset_profile(dev)
        return
    if args.case == "kernels":
        kernel_times(dev)
        return
    if args.case == "bsgs-v1":
        bsgs_v1_times(dev)
        return
    if args.case == "slot-kernel":
        slot_kernel_times(dev)
        return
    gather = args.case == "cylinder-gather"
    for pallas in (True,) if gather else (True, False):
        profile(dev, MESHES[args.case], WARM_STEPS, pallas, args.case,
                args.pc)


if __name__ == "__main__":
    main()
