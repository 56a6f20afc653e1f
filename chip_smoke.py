"""Smoke test of the PyTorch/CUDA port (fvens_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths on the card, each through both CUDA kernels'
wrappers with the launch counts zeroed just before it and read just after:

  - the large-mesh path: the inviscid cylinder of
    cases/bigmesh_case.run_solve at its full 640x320 mesh (204,800 cells,
    n = 819,200; M 0.38, HLLC, weighted least squares, LINEAR; a
    first-order starter, then the second-order main solve, CFL 500 -> 5000
    to an absolute residual of 1e-10; f32 Jacobian/Krylov inside the f64
    residual/update; FGMRES(90) at rtol 1e-2, bsgs x6, banded). gmres takes
    its blocked path there by itself, whose basis appends are the row_set
    kernel;
  - the bench path of the first slice: the banded laminar NACA0012 solve on
    naca0012_omesh(160, 80) (cases/bench_case.run_solve, 600 steps).

In order:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds csrc/banded_apply.cu and csrc/row_set.cu from the checkout, one
     nvcc each, both at once, and prints ptxas's registers and spills;
  3. holds banded_apply against its plain PyTorch twin on the real step-0
     operators of both paths (matvec K=7, D^-1 v K=1, bsgs sweep K=6) at
     f32 (max abs error <= 1e-5 max|y|) and f64 (<= 1e-12 max|y|), and
     row_set against its twin at n = 819,200 (the 640x320 basis) and
     262,528 (where the TPU kernel's tile gate refuses the row) at f32 and
     f64: bit for bit, the other basis rows unchanged, V's storage
     unchanged; times both;
  4. runs the 640x320 cylinder solve (a warm-up solve, then the timed one):
     gmres must run blocked (n >= linear._BLOCKED_N_THRESHOLD), the main
     solve must converge to 1e-10 with a finite state, row_set must launch
     once per Krylov iteration (each appends one basis row) and
     banded_apply at least 8 times per Krylov iteration. The run's counts
     are printed beside the JAX package's TPU counts of the same case in
     BENCH_BIGMESH.json, as context only;
  5. runs the 160x80 cylinder with gmres forced blocked and holds it to
     the JAX package's CPU runs in records/jax_bigmesh_history.json: it
     must converge, its starter must take the record's steps (Krylov
     iterations within 2%), its first AGREE_STEPS main steps must match the
     blocked record step for step (Krylov iterations within 1, residuals
     within 1%), and its main steps and Krylov iterations must be within
     10% of the JAX package's run on either GMRES path. The two JAX runs
     agree with each other step for step until the residual nears 1e-7 and
     then part (blocked 54 steps / 1,318 iterations, classic 49 / 850), so
     an endgame nearer to one of them than 10% of the other is no fault;
  6. runs the bench solve (its full 600 steps), whose state must stay finite
     with at least 8 banded_apply launches per Krylov iteration. It must
     reach 1e-10 if the JAX package's own solve of the same case did
     (JAX_RECORD, made by records/jax_bench_history.py); on this generated
     mesh that solve does not converge, but cycles between residuals near
     1e-3 and blowups, and the port's lowest residual must then be within
     10x of the JAX package's;
  7. runs the first-order (starter) form of the bench solve, which must
     converge to 1e-10 through the kernel in the steps and Krylov
     iterations of the JAX package's run (JAX_RECORD);
  8. runs the bench's first steps again through the plain twins: 3 steps
     in full f64 (equal Krylov iterations per step, residuals to 1e-4), and
     the first step in mixed precision (equal iterations, the two residuals
     it determines to 1e-4). Later mixed-precision steps are not compared:
     at step 2 the f32 Krylov solve stops unconverged at 90 iterations and
     the trajectory turns chaotic (a rounding-level change becomes a
     residual tens of percent apart at step 3);
  9. holds small solves on the card, through the kernel, to the JAX
     package's histories of the same inputs (SMALL_CASES).

Any failure exits non-zero before the result. The last line of standard
output is {"ok": true, "device": {...}}; the line before it holds the
kernel record, and the one before that the seconds each phase took.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

KERNELS = {                     # name: (source, the TPU kernel it replaces)
    "banded_apply": ("fvens_tpu_torch/csrc/banded_apply.cu",
                     "fvens_tpu/solver/pallas_banded.py:107"),
    "row_set": ("fvens_tpu_torch/csrc/row_set.cu",
                "fvens_tpu/solver/pallas_banded.py:254"),
}
TIMED_RUNS = 50
# The JAX package's starter -> main runs of the cylinder case on the CPU
# with x64 (records/jax_bigmesh_history.py), and its TPU runs of the same
# case at 640x320 (scripts/bench_bigmesh.py; counts only, as context).
JAX_BIGMESH_RECORD = "records/jax_bigmesh_history.json"
TPU_BIGMESH = "BENCH_BIGMESH.json"
CHECK_MESH = (160, 80)           # the cylinder mesh held to the JAX record
AGREE_STEPS = 30                 # main steps held to it step for step
ROWSET_SIZES = (819_200, 262_528)
# The JAX package's 600-step runs of the bench solve and its first-order
# form on the CPU with x64 (records/jax_bench_history.py).
JAX_RECORD = "records/jax_bench_history.json"

# The small solves of step 9: the bench physics and solver on
# naca0012_omesh(64, 16) from free stream. `ref` is the JAX package's
# history on the CPU with x64, (residual, Krylov iterations) per step;
# tests/test_torch_steady.py recomputes it and holds these numbers to it.
# A step passes with iterations within `iters` and a residual within
# `res` * max(its reference, the first step's). The second-order solves
# start at CFL 50, where every Krylov solve converges and the history is
# not chaotic; the first-order solve runs the bench's CFL 500 -> 5000 and
# converges to 1e-10 at step 12.
SMALL_MESH = (64, 16)
SMALL_CASES = (
    dict(order2=True, mixed=False, cfl=(50.0, 500.0), iters=0, res=1e-9,
         ref=((0.004550080908796354, 3), (0.01783935737615198, 5),
              (0.026643891582822432, 4), (0.060447761505014706, 4),
              (0.08297698897761722, 3))),
    dict(order2=True, mixed=True, cfl=(50.0, 500.0), iters=1, res=1e-4,
         ref=((0.004550080908796354, 3), (0.017839362372085044, 5),
              (0.026643886990212248, 4))),
    dict(order2=False, mixed=False, cfl=(500.0, 5000.0), iters=0, res=1e-9,
         ref=((0.00335976637892687, 8), (0.05448033407851273, 12),
              (0.005556051403003637, 10), (0.0026731315321183555, 15),
              (0.0002936375460214496, 19), (2.9127488872958013e-05, 22),
              (1.5125613948753131e-06, 27), (1.0636789925952186e-07, 25),
              (1.449988974291442e-08, 25), (1.7446546446648528e-09, 29),
              (2.962483996052874e-10, 31), (4.267653691212231e-11, 31))),
)


class SmokeFailure(RuntimeError):
    pass


PHASES = {}                      # phase name: seconds on the host clock


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    PHASES[name] = time.perf_counter() - t0
    print(f"phase {name}: {PHASES[name]:.2f} s", flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def event_ms(fn, runs=TIMED_RUNS):
    """Median CUDA-event time of fn() in ms over `runs` calls, after a
    warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _load(rel: str):
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           rel)) as f:
        return json.load(f)


def jax_record(order2: bool, mixed: bool) -> dict:
    """The JAX package's run of the bench solve in JAX_RECORD."""
    return next(s for s in _load(JAX_RECORD)["solves"]
                if s["order2"] == order2 and s["mixed"] == mixed)


def cylinder_record(mesh: str) -> list:
    """The JAX package's runs of the cylinder case on `mesh` (e.g.
    "cylinder_omesh(160, 80)") in JAX_BIGMESH_RECORD, blocked GMRES first."""
    return sorted((r for r in _load(JAX_BIGMESH_RECORD)["runs"]
                   if r["mesh"] == mesh),
                  key=lambda r: not r["blocked_gmres"])


def build_kernels():
    """Both CUDA libraries, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from fvens_tpu_torch.solver import banded_kernels as bk
    from fvens_tpu_torch.solver import rowset_kernels as rk
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        jobs = {name: ex.submit(mod.load_library)
                for name, mod in (("banded_apply", bk), ("row_set", rk))}
        builds = {name: job.result() for name, job in jobs.items()}
    print(f"build: {time.perf_counter() - t0:.2f} s for both", flush=True)
    for name, build in builds.items():
        print(f"  {name}: nvcc {build.seconds:.2f} s -> "
              f"{os.path.relpath(build.path)}", flush=True)
        for line in build.log.splitlines():
            if "registers" in line or "spill" in line:
                print("    ptxas:", line.strip(), flush=True)


def banded_checks(dev, path: str, make):
    """banded_apply vs its plain twin on the step-0 operators of one path,
    at f32 (the mixed-precision Krylov system) and f64 (mixed precision
    off). `make(mixed)` returns (solver, mesh)."""
    import torch
    from fvens_tpu_torch.cases.casesolvers import initial_state
    from fvens_tpu_torch.solver import banded_kernels as bk

    rng = np.random.default_rng(0)
    rows = []
    for mixed, tol in ((True, 1e-5), (False, 1e-12)):
        solver, cm = make(mixed)
        _, _, ops = solver.step_operators(
            cm, initial_state(solver.space, cm), solver.cfg.cfl_init)
        dtype = ops.D.dtype
        bands7, d7 = bk.matvec_bands(ops.D, ops.Bt, ops.bl.offsets)
        (bands1, d1), (bands6, d6) = bk.bsgs_bands(ops.Dinv, ops.DNbt,
                                                   ops.bl.offsets)
        x = torch.from_numpy(rng.standard_normal((cm.NC, 4))).to(dev, dtype)
        base = bk.banded_apply_plain(bands1, x, d1)
        cases = (("matvec", bands7, d7, 1.0, None),
                 ("dinv", bands1, d1, 1.0, None),
                 ("sweep", bands6, d6, -1.0, base))
        for name, bands, dms, sign, b in cases:
            y = bk.banded_apply(bands, x, dms, sign, b)
            torch.cuda.synchronize()
            yp = bk.banded_apply_plain(bands, x, dms, sign, b)
            err = float((y - yp).abs().max())
            scale = float(yp.abs().max())
            row = dict(path=path, NC=cm.NC, op=name, K=bands.shape[0],
                       dtype=str(dtype)[6:], max_abs_err=err,
                       max_abs_y=scale, tol=tol * scale)
            check(np.isfinite(err) and err <= tol * scale,
                  f"banded_apply disagrees with its twin: {row}")
            row["ms"] = event_ms(lambda: bk.banded_apply(bands, x, dms,
                                                         sign, b))
            row["plain_ms"] = event_ms(lambda: bk.banded_apply_plain(
                bands, x, dms, sign, b))
            rows.append(row)
            print("banded_apply check", json.dumps(row), flush=True)
    return rows


def rowset_checks(dev):
    """row_set vs its plain twin on a (96, n) basis, the blocked path's
    FGMRES(90) basis, at f32 and f64: bit for bit, only row j written, in
    place."""
    import torch
    from fvens_tpu_torch.solver import rowset_kernels as rk

    rng = np.random.default_rng(1)
    j = 37
    rows = []
    for n in ROWSET_SIZES:
        for dtype in (torch.float32, torch.float64):
            V = torch.from_numpy(rng.standard_normal((96, n))).to(dev, dtype)
            w = torch.from_numpy(rng.standard_normal(n)).to(dev, dtype)
            hn = torch.sqrt(torch.sum(w * w))
            V0, ptr = V.clone(), V.data_ptr()
            out = rk.row_set(V, j, w, hn)
            torch.cuda.synchronize()
            want = rk.rowset_plain(V0.clone(), j, w, hn)
            row = dict(n=n, dtype=str(dtype)[6:], j=j,
                       max_abs_err=float((V - want).abs().max()))
            check(out is V and V.data_ptr() == ptr,
                  f"row_set did not write the basis in place: {row}")
            check(torch.equal(V[j], want[j]),
                  f"row_set differs from its twin: {row}")
            check(torch.equal(V[:j], V0[:j]) and torch.equal(V[j + 1:],
                                                           V0[j + 1:]),
                  f"row_set wrote another row: {row}")
            row["ms"] = event_ms(lambda: rk.row_set(V, j, w, hn))
            row["plain_ms"] = event_ms(lambda: rk.rowset_plain(V, j, w, hn))
            rows.append(row)
            print("row_set check", json.dumps(row), flush=True)
    return rows


def cylinder_solvers(dev):
    """make(mixed) -> (main solver, mesh) of the 640x320 cylinder case."""
    import dataclasses

    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.cases.casesolvers import SteadyFlowCase, build_space
    case, cm, _ = bigmesh_case.build_case(dev, *bigmesh_case.BIGMESH)

    def make(mixed):
        cfg = case.cfg
        if not mixed:
            cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
                cfg.linear, mixed_precision=False))
        return SteadyFlowCase(cfg)._make_solver(build_space(cfg),
                                                cfg.main), cm
    return make


def cylinder_path(dev):
    """The large-mesh main path, counted: bigmesh_case.run_solve at
    640x320. Returns (report, launches)."""
    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.solver import banded_kernels as bk
    from fvens_tpu_torch.solver import linear
    from fvens_tpu_torch.solver import rowset_kernels as rk

    torch.cuda.synchronize()
    bk.banded_apply.launches = 0
    rk.row_set.launches = 0
    u, rep = bigmesh_case.run_solve(dev)
    torch.cuda.synchronize()
    launches = {"banded_apply": bk.banded_apply.launches,
                "row_set": rk.row_set.launches}
    print("cylinder solve", json.dumps(dict(rep, launches=launches)),
          flush=True)
    tpu = next(r for r in _load(TPU_BIGMESH)["runs"]
               if r["size"] == "640x320" and r.get("banded")
               and r.get("stop") == "abs" and r["platform"] == "tpu")
    print(f"context, no check: the JAX package's TPU run of this case "
          f"({TPU_BIGMESH}) took {tpu['steps']} main steps and "
          f"{tpu['lin_iters']} Krylov iterations; this run "
          f"{rep['main_steps']} and {rep['main_krylov_iters']}", flush=True)
    its = rep["krylov_iters_all"]
    check(rep["n"] >= linear._BLOCKED_N_THRESHOLD and rep["blocked"],
          f"n = {rep['n']} is below the blocked-GMRES threshold")
    check(rep["converged"] and rep["abs_res"] <= bigmesh_case.TOL_ABS,
          f"the cylinder solve did not converge to {bigmesh_case.TOL_ABS}: "
          f"{rep['abs_res']!r} after {rep['main_steps']} steps")
    check(u.dtype == torch.float64 and bool(torch.isfinite(u).all())
          and np.isfinite(rep["entropy"]), "non-finite cylinder solution")
    check(its > 0 and launches["row_set"] == its,
          f"{launches['row_set']} row_set launches for {its} basis appends")
    check(launches["banded_apply"] >= 8 * its,
          f"{launches['banded_apply']} banded_apply launches < 8 x {its} "
          "Krylov iterations")
    return rep, launches


def cylinder_vs_record(dev):
    """The CHECK_MESH cylinder with gmres forced blocked, against the JAX
    package's runs in JAX_BIGMESH_RECORD."""
    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.solver import linear
    from fvens_tpu_torch.solver import rowset_kernels as rk

    mesh = f"cylinder_omesh{CHECK_MESH}"
    recs = cylinder_record(mesh)
    blk = recs[0]
    check(blk["blocked_gmres"], f"no blocked-GMRES record of {mesh}")
    saved = linear._BLOCKED_N_THRESHOLD
    linear._BLOCKED_N_THRESHOLD = 0
    try:
        case, cm, u0 = bigmesh_case.build_case(dev, *CHECK_MESH)
        n0 = rk.row_set.launches
        u, info = case.solve(cm, u0)
        torch.cuda.synchronize()
        appends = rk.row_set.launches - n0
    finally:
        linear._BLOCKED_N_THRESHOLD = saved
    st = case.starter_info
    print(f"{mesh} blocked: starter {st.steps} steps / "
          f"{st.total_lin_iters} iterations, main {info.steps} / "
          f"{info.total_lin_iters}, final {info.finalres!r}; the JAX "
          "package's: " + "; ".join(
              f"{'blocked' if r['blocked_gmres'] else 'classic'} starter "
              f"{r['starter']['steps']} / {r['starter']['krylov_iters']}, "
              f"main {r['main']['steps']} / {r['main']['krylov_iters']}"
              for r in recs), flush=True)
    check(info.converged and bool(torch.isfinite(u).all()),
          f"the {mesh} solve did not converge")
    check(appends == st.total_lin_iters + info.total_lin_iters,
          f"{appends} row_set launches: gmres did not run blocked")
    s = blk["starter"]
    check(st.steps == s["steps"] and abs(st.total_lin_iters
                                         - s["krylov_iters"])
          <= 0.02 * s["krylov_iters"],
          "the starter departs from the JAX package's")
    ref = blk["main"]["history"]
    check(len(info.history) >= AGREE_STEPS,
          f"the main solve took only {len(info.history)} steps")
    for k in range(AGREE_STEPS):
        (_, res_ref, _, it_ref), h = ref[k], info.history[k]
        check(abs(h[4] - it_ref) <= 1 and abs(h[2] - res_ref)
              <= 0.01 * res_ref,
              f"main step {k + 1}: iterations {h[4]} vs {it_ref}, residual "
              f"{h[2]!r} vs {res_ref!r}")

    def near(r):
        return (abs(info.steps - r["main"]["steps"])
                <= 0.1 * r["main"]["steps"]
                and abs(info.total_lin_iters - r["main"]["krylov_iters"])
                <= 0.1 * r["main"]["krylov_iters"])
    check(any(near(r) for r in recs),
          f"main steps and iterations ({info.steps}, "
          f"{info.total_lin_iters}) are not within 10% of either JAX run")


def bench_path(dev):
    """The first slice's bench solve, counted."""
    import torch
    from fvens_tpu_torch.cases.bench_case import (BENCH_MESH, MAX_STEPS,
                                                  TOL_ABS, run_solve)
    from fvens_tpu_torch.solver import banded_kernels as bk

    solve, cm = run_solve(dev)
    print(f"mesh: naca0012_omesh{BENCH_MESH}, {cm.n_cells} cells", flush=True)
    torch.cuda.synchronize()
    bk.banded_apply.launches = 0
    t0 = time.perf_counter()
    u, info = solve(max_steps=MAX_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bk.banded_apply.launches
    res = [h[2] for h in info.history]
    solve_rec = dict(converged=info.converged, steps=info.steps,
                     step_calls=len(info.step_times),
                     krylov_iters=info.total_lin_iters, wall_s=wall,
                     cell_updates_per_s=cm.n_cells * info.steps / wall,
                     launches=launches, first_res=res[0], min_res=min(res),
                     final_res=info.finalres, tol_abs=TOL_ABS)
    print("bench solve", json.dumps(solve_rec), flush=True)
    ref = jax_record(order2=True, mixed=True)
    print("JAX package's solve", json.dumps(
        {k: ref[k] for k in ("converged", "steps", "krylov_iters",
                             "min_res", "final_res", "recoveries")}),
          f"({JAX_RECORD})", flush=True)
    if ref["converged"]:
        check(info.converged, f"the solve did not converge to {TOL_ABS} "
              f"in {info.steps} steps; the JAX package's did")
    else:
        print(f"bench solve: not converged to {TOL_ABS} in {info.steps} "
              "steps, nor is the JAX package's", flush=True)
        check(ref["min_res"] / 10 <= min(res) <= 10 * ref["min_res"],
              f"lowest residual {min(res)!r} is not within 10x of the JAX "
              f"package's {ref['min_res']!r}")
    check(u.shape == (cm.NC, 4) and u.dtype == torch.float64
          and bool(torch.isfinite(u).all()), "non-finite solution")
    check(all(np.isfinite(r) for r in res), "non-finite accepted residual")
    check(info.total_lin_iters > 0
          and launches >= 8 * info.total_lin_iters,
          f"{launches} kernel launches < 8 x {info.total_lin_iters} "
          "Krylov iterations")
    return cm


def bench_first_order(dev, cm):
    """The first-order (starter) form of the bench solve converges."""
    import torch
    from fvens_tpu_torch.cases.bench_case import MAX_STEPS, TOL_ABS, run_solve
    from fvens_tpu_torch.solver import banded_kernels as bk

    solve1, _ = run_solve(dev, order2=False)
    n0 = bk.banded_apply.launches
    t0 = time.perf_counter()
    u1, info1 = solve1(max_steps=MAX_STEPS)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    launches1 = bk.banded_apply.launches - n0
    ref1 = jax_record(order2=False, mixed=True)
    print("first-order solve", json.dumps(dict(
        converged=info1.converged, steps=info1.steps,
        krylov_iters=info1.total_lin_iters, wall_s=wall1,
        cell_updates_per_s=cm.n_cells * info1.steps / wall1,
        launches=launches1, final_res=info1.finalres,
        jax_cpu_steps=ref1["steps"],
        jax_cpu_krylov_iters=ref1["krylov_iters"])), flush=True)
    check(info1.converged and info1.finalres <= TOL_ABS
          and bool(torch.isfinite(u1).all()),
          "the first-order solve did not converge")
    check(ref1["converged"] and info1.steps == ref1["steps"]
          and abs(info1.total_lin_iters - ref1["krylov_iters"])
          <= 0.02 * ref1["krylov_iters"],
          "the first-order solve departs from the JAX package's")
    check(launches1 >= 8 * info1.total_lin_iters,
          f"{launches1} kernel launches < 8 x {info1.total_lin_iters} "
          "Krylov iterations in the first-order solve")


def bench_twins(dev, cm):
    """The bench's first steps through the kernel and through the twins."""
    from fvens_tpu_torch.cases.bench_case import bench_solver
    from fvens_tpu_torch.cases.casesolvers import initial_state

    for mixed, nsteps, ncompare in ((False, 3, 3), (True, 2, 1)):
        hist = {}
        for pallas in (True, False):
            s, _ = bench_solver(dev, mixed=mixed, pallas=pallas)
            hist[pallas] = s.solve(cm, initial_state(s.space, cm),
                                   max_steps=nsteps)[1].history
        for k in range(nsteps):
            a, b = hist[True][k], hist[False][k]
            rel = abs(a[2] - b[2]) / abs(b[2])
            print(f"twin step {k + 1} mixed={mixed}: iters {a[4]} vs "
                  f"{b[4]}, res {a[2]!r} vs {b[2]!r} (rel {rel:.3e})",
                  flush=True)
            check(rel <= 1e-4, f"residuals differ at step {k + 1}")
            if k < ncompare:
                check(a[4] == b[4], f"Krylov iterations differ at step "
                      f"{k + 1}")


def small_history(dev, case: dict):
    """Per-step history of one of SMALL_CASES on `dev`, through the
    kernel."""
    import dataclasses
    from fvens_tpu_torch.cases.bench_case import bench_solver
    from fvens_tpu_torch.cases.casesolvers import initial_state

    solver, cm = bench_solver(dev, mesh=SMALL_MESH, mixed=case["mixed"],
                              order2=case["order2"])
    solver.cfg = dataclasses.replace(solver.cfg, cfl_init=case["cfl"][0],
                                     cfl_fin=case["cfl"][1])
    return solver.solve(cm, initial_state(solver.space, cm),
                        max_steps=len(case["ref"]))[1].history


def small_solves(dev):
    for case in SMALL_CASES:
        ref = case["ref"]
        hist = small_history(dev, case)
        name = f"order2={case['order2']} mixed={case['mixed']}"
        check(len(hist) == len(ref), f"small solve {name} ran {len(hist)} "
              f"steps, not {len(ref)}")
        for k, ((res_ref, it_ref), h) in enumerate(zip(ref, hist)):
            err = abs(h[2] - res_ref)
            print(f"reference {name} step {k + 1}: iters {h[4]} vs {it_ref}, "
                  f"res {h[2]!r} vs {res_ref!r} (abs {err:.3e})", flush=True)
            check(abs(h[4] - it_ref) <= case["iters"]
                  and err <= case["res"] * max(res_ref, ref[0][0]),
                  f"small solve {name} departs from the JAX package at "
                  f"step {k + 1}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this test runs only on a GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fvens_tpu_torch.cases.bench_case import bench_solver

    dev = torch.device("cuda", 0)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)

    with phase("build"):
        build_kernels()
    with phase("kernel checks"):
        brows = banded_checks(dev, "cylinder 640x320", cylinder_solvers(dev))
        brows += banded_checks(dev, "bench 160x80",
                               lambda mixed: bench_solver(dev, mixed=mixed))
        rrows = rowset_checks(dev)
    with phase("cylinder 640x320 solve (warm-up + timed)"):
        rep, launches = cylinder_path(dev)
    with phase(f"cylinder {CHECK_MESH[0]}x{CHECK_MESH[1]} vs the JAX record"):
        cylinder_vs_record(dev)
    with phase("bench 600-step solve"):
        cm = bench_path(dev)
    with phase("bench first-order solve"):
        bench_first_order(dev, cm)
    with phase("bench twin steps"):
        bench_twins(dev, cm)
    with phase("small solves vs the JAX package"):
        small_solves(dev)

    sweep = next(r for r in brows if r["op"] == "sweep"
                 and r["dtype"] == "float32" and r["path"].startswith("cyl"))
    rs32 = next(r for r in rrows if r["n"] == ROWSET_SIZES[0]
                and r["dtype"] == "float32")
    measured = {
        "banded_apply": dict(
            max_abs_err=max(r["max_abs_err"] for r in brows),
            ms=sweep["ms"], plain_ms=sweep["plain_ms"],
            shape=f"f32 bsgs sweep, K=6, NC={sweep['NC']}"),
        "row_set": dict(
            max_abs_err=max(r["max_abs_err"] for r in rrows),
            ms=rs32["ms"], plain_ms=rs32["plain_ms"],
            shape=f"f32 row {rs32['j']} of a (96, {rs32['n']}) basis"),
    }
    print("phases", json.dumps(PHASES), flush=True)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=replaces,
             launches=launches[name], **measured[name])
        for name, (src, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
