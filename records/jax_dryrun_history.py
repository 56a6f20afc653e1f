"""The JAX package's distributed dry run, recorded.

    JAX_PLATFORMS=cpu python records/jax_dryrun_history.py [--parts 2 4 8]
        [--out FILE]

Runs __graft_entry__.dryrun_multichip(D) for each D on D of 8 virtual CPU
devices (the module stages --xla_force_host_platform_device_count=8), as
`python __graft_entry__.py` does for D = 8: on cylinder_omesh(8 D, 6) at
f32 (M 0.38, viscous, HLLC, weighted least squares, LINEAR, adiabatic wall
on marker 2, far field on marker 4), one explicit step at CFL 0.5, one
ShardedFlow.be_step_fn step and one DistributedBackwardEuler step each
matrix-free, banded (bsgs) and deflated (k = 4) at CFL 50, rtol 0.1, the
bcsgs and ilu0 mini-solves to a relative residual of 1e-4, and
halo_schedule_stats. About 1 minute for D = 2 on an 8-core x86-64 host.

Writes records/jax_dryrun_history.json: the function's configuration and
the SHA-256 of its source (so a reader can tell the record is this
function's), the agreement limits another implementation is held to
(LIMITS), and per D the printed line, every number of it parsed, and the
mini-solves' per-step histories (step, residual, CFL, Krylov iterations),
logged as each runs.
"""

import argparse
import contextlib
import hashlib
import inspect
import io
import json
import os
import platform
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import __graft_entry__ as graft  # noqa: E402  (stages the virtual devices)

PARTS = (2, 4, 8)
# The dry run's configuration, as __graft_entry__.dryrun_multichip builds it.
CONFIG = dict(
    mesh="cylinder_omesh(8 * n_devices, 6)", dtype="float32",
    physics=dict(Minf=0.38, viscous=True),
    numerics=dict(flux="HLLC", gradient="LEASTSQUARES",
                  reconstruction="LINEAR", order2=True),
    bcs=[dict(marker=2, type="adiabaticwall", values=[0.0]),
         dict(marker=4, type="farfield")],
    explicit=dict(cfl=0.5),
    implicit=dict(cfl=50.0, rtol=0.1,
                  lin=dict(restart=20, maxiter=20, rtol=0.1,
                           rtol_adapt=False),
                  nl=dict(scheme="robust_flow")),
    forms=dict(matrix_free=dict(matrix_free=True),
               banded=dict(pc="bsgs", banded=True),
               deflated=dict(deflation_k=4)),
    mini_solves=dict(
        pt=dict(cfl_init=25.0, cfl_fin=500.0, tol=1e-4, maxiter=150),
        lin=dict(restart=30, maxiter=30, rtol=1e-2),
        pcs=dict(bcsgs=1, ilu0=3)),
    halo_value_bytes=4)
# How closely another implementation of the dry run is held to these runs:
# the halo statistics, the five single steps' Krylov iterations and the
# mini-solves' steps equal; every residual within `res` (relative); the
# mini-solves' Krylov iterations within `lin_iters` (relative) of these.
LIMITS = dict(res=1e-5, lin_iters=0.1)

_NUM = r"([-+0-9.e]+)"
_LINE = re.compile(
    r"dryrun_multichip\((\d+)\): ok, explicit res " + _NUM
    + r", implicit res " + _NUM + r" \((\d+) Krylov iters\), "
    r"matrix-free implicit res " + _NUM + r" \((\d+) Krylov iters\), "
    r"banded implicit res " + _NUM + r" \((\d+) Krylov iters\), "
    r"deflated implicit res " + _NUM + r" \((\d+) Krylov iters\), "
    r"mini-solve pc=bcsgs converged rel 1e-4 in (\d+) steps "
    r"\((\d+) lin iters\), "
    r"mini-solve pc=ilu0 converged rel 1e-4 in (\d+) steps "
    r"\((\d+) lin iters\); "
    r"halo schedule: (\d+) (?:ppermute|exchange) rounds, "
    r"(\d+) messages/exchange, (\d+) halo cells \((\d+) B/exchange\) "
    r"vs edge cut (\d+) faces")


def parse_line(line: str) -> dict:
    """Every number of a dry-run line (the JAX function's or the port's)."""
    m = _LINE.search(line)
    if m is None:
        raise ValueError(f"not a dryrun_multichip line: {line!r}")
    g = m.groups()
    steps = {}
    for i, name in enumerate(("implicit", "matrix_free", "banded",
                              "deflated")):
        steps[name] = dict(res=float(g[2 + 2 * i]),
                           krylov_iters=int(g[3 + 2 * i]))
    return dict(
        n_devices=int(g[0]), explicit_res=float(g[1]), steps=steps,
        mini_solves=dict(bcsgs=dict(steps=int(g[10]), lin_iters=int(g[11])),
                         ilu0=dict(steps=int(g[12]), lin_iters=int(g[13]))),
        halo=dict(rounds=int(g[14]), messages_per_exchange=int(g[15]),
                  halo_cells=int(g[16]), bytes_per_exchange=int(g[17]),
                  cut_faces=int(g[18])))


def source_sha256() -> str:
    return hashlib.sha256(
        inspect.getsource(graft.dryrun_multichip).encode()).hexdigest()


class _History:
    """A logger that keeps (step, residual, CFL, Krylov iterations)."""

    def __init__(self, rows):
        self.rows = rows

    def log(self, step, relres, absres, lin_iters=0, cfl=0.0, **_):
        self.rows.append([int(step), float(absres), float(cfl),
                          int(lin_iters)])


def run(D: int) -> dict:
    from fvens_tpu.dist.shard import ShardedFlow

    histories = []
    solve_implicit = ShardedFlow.solve_implicit

    def recording(self, *a, **k):
        rows = []
        histories.append(rows)
        return solve_implicit(self, *a, logger=_History(rows), **k)

    out = io.StringIO()
    ShardedFlow.solve_implicit = recording
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            graft.dryrun_multichip(D)
    finally:
        ShardedFlow.solve_implicit = solve_implicit
    wall = time.perf_counter() - t0
    line = [ln for ln in out.getvalue().splitlines()
            if ln.startswith("dryrun_multichip(")][-1]
    rec = dict(line=line, parsed=parse_line(line), host_seconds=wall)
    rec["mini_solve_history"] = dict(zip(("bcsgs", "ilu0"), histories))
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", type=int, nargs="+", default=list(PARTS))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "records", "jax_dryrun_history.json"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    runs = []
    for D in args.parts:
        rec = run(D)
        print(rec["line"], f"({rec['host_seconds']:.1f} s)", flush=True)
        runs.append(rec)
    with open(args.out, "w") as f:
        json.dump(dict(
            function="__graft_entry__.dryrun_multichip",
            source_sha256=source_sha256(), config=CONFIG, limits=LIMITS,
            host=dict(machine=platform.machine(), cpus=os.cpu_count(),
                      python=platform.python_version(),
                      jax=jax.__version__),
            runs=runs), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
