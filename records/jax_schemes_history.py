"""The JAX package's runs of the schemes and steppers, recorded.

    JAX_PLATFORMS=cpu python records/jax_schemes_history.py [--out FILE]
        [--only naca,explicit,vortex,heat]

Runs on the CPU with x64 (about 11 minutes on an 8-core x86-64 host: naca
539 s, explicit 94 s, vortex 4 s, heat 12 s) and writes
records/jax_schemes_history.json with:

  - naca: `python -m fvens_tpu.cases.cli` in this process on
    fvens_tpu_torch/cases/ctrl/naca0012-transonic.ctrl with
    `-options_file naca0012-transonic.solverc` on naca0012_omesh(160, 80)
    (written with the JAX package's write_gmsh2), `--log_every 1`,
    `--functionals_every 10` and `--history`: the transonic NACA0012 (M 0.8,
    AoA 1.25, HLLC, least squares, WENO with lambda = 0), starter then main.
    The starter's Krylov iterations per step (its monitor lines), the main
    solve's per-step relres, absres, CFL and Krylov iterations (the JSONL
    history), its totals, the logged functionals, whether it converged
    (the CLI raises the solver's ToleranceError when it does not; the
    history is complete then) and, where it did, the functionals it prints;
  - explicit: the same CLI on cylinder-explicit.ctrl (first order, Roe,
    forward Euler at CFL 0.8) on cylinder_omesh(160, 80, stretch=
    1.15**(20/80)): the whole run to the ctrl's tolerance (steps, final
    relres, functionals, wall) and the history of its first 200 steps;
  - vortex: TVD-RK3 at CFL 0.8 on the 64x64 periodic vortex box of
    tests/test_unsteady.py (its vortex_state) to t = 0.5: steps, final t,
    mass before and after, the L2 density error against the exact vortex
    advected by t and the vortex's own L2 deviation, and the final state
    (float64 bytes, base64);
  - heat: the L2 errors of tests/test_heat.py's solve_one at n = 8, 16 and
    32 on triangles and quads (implicit), and explicit at n = 8 on quads.

It imports chip_smoke's parse_cli_output, the one parser of both CLIs'
printed output. The last run's wall times are in the record ("host").
"""

import argparse
import base64
import contextlib
import io
import json
import os
import platform
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from chip_smoke import FUNCTIONALS, parse_cli_output  # noqa: E402

CTRL_DIR = "fvens_tpu_torch/cases/ctrl"
NACA_CTRL = f"{CTRL_DIR}/naca0012-transonic.ctrl"
NACA_SOLVERC = f"{CTRL_DIR}/naca0012-transonic.solverc"
EXPLICIT_CTRL = f"{CTRL_DIR}/cylinder-explicit.ctrl"
MESH = (160, 80)
FUNCTIONALS_EVERY = 10
EXPLICIT_STEPS = 200
VORTEX = dict(n=64, order=3, cfl=0.8, final_time=0.5)
HEAT_N = (8, 16, 32)


def read_history(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def run_cli(argv):
    """(rc or the exception's name, wall s, printed text) of the JAX CLI."""
    from fvens_tpu.cases import cli
    from fvens_tpu.solver.steady import ToleranceError
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    except ToleranceError:
        rc = "ToleranceError"
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    print(text)
    return rc, wall, text


def history_rows(rows):
    return [dict(step=r["step"], relres=r["relres"], absres=r["absres"],
                 cfl=r["cfl"], lin_iters=r["lin_iters"]) for r in rows]


def naca(tmp):
    from fvens_tpu.cases.convertformat import write_gmsh2
    from fvens_tpu.mesh.meshgen import naca0012_omesh
    ni, nj = MESH
    msh = os.path.join(tmp, "naca.msh")
    write_gmsh2(msh, naca0012_omesh(ni, nj))
    hist = os.path.join(tmp, "naca.jsonl")
    rc, wall, text = run_cli([
        os.path.join(ROOT, NACA_CTRL), "--mesh_file", msh, "-options_file",
        os.path.join(ROOT, NACA_SOLVERC), "--platform", "cpu",
        "--log_every", "1", "--functionals_every", str(FUNCTIONALS_EVERY),
        "--history", hist])
    rows = read_history(hist)
    out = parse_cli_output(text)
    starter = out["starter_iters"]
    converged = rc == 0
    rel = [r["relres"] for r in rows]
    return dict(
        case=dict(ctrl=NACA_CTRL, solverc=NACA_SOLVERC,
                  mesh=f"naca0012_omesh({ni}, {nj})",
                  argv=["python -m fvens_tpu.cases.cli", NACA_CTRL,
                        "--mesh_file", "<mesh>", "-options_file",
                        NACA_SOLVERC, "--platform", "cpu", "--log_every",
                        "1", "--functionals_every", str(FUNCTIONALS_EVERY),
                        "--history", "<history>"]),
        wall_s=wall, exit=rc, converged=converged,
        starter=dict(steps=len(starter), krylov_iters=sum(starter),
                     lin_iters=starter),
        main=dict(steps=len(rows),
                  krylov_iters=sum(r["lin_iters"] for r in rows),
                  min_relres=min(rel), min_relres_step=rel.index(min(rel)) + 1,
                  final_relres=rel[-1], history=history_rows(rows),
                  functionals_logged=[
                      {k: r[k] for k in ("step",) + FUNCTIONALS}
                      for r in rows if "CL" in r]),
        functionals=({k: out[k] for k in FUNCTIONALS} if converged
                     else None))


def explicit(tmp):
    from fvens_tpu.cases.convertformat import write_gmsh2
    from fvens_tpu.mesh.meshgen import cylinder_omesh
    ni, nj = MESH
    msh = os.path.join(tmp, "cyl.msh")
    write_gmsh2(msh, cylinder_omesh(ni, nj, stretch=1.15 ** (20.0 / nj)))
    with open(os.path.join(ROOT, EXPLICIT_CTRL)) as f:
        text = f.read()
    assert "max_timesteps  100000" in text
    short = os.path.join(tmp, "short.ctrl")
    with open(short, "w") as f:
        f.write(text.replace("max_timesteps  100000",
                             f"max_timesteps  {EXPLICIT_STEPS}"))
    runs = {}
    for name, ctrl in (("full", os.path.join(ROOT, EXPLICIT_CTRL)),
                       ("first", short)):
        hist = os.path.join(tmp, f"{name}.jsonl")
        rc, wall, printed = run_cli([ctrl, "--mesh_file", msh, "--platform",
                                     "cpu", "--log_every", "0", "--history",
                                     hist])
        runs[name] = (rc, wall, parse_cli_output(printed),
                      read_history(hist))
    rc, wall, out, rows = runs["full"]
    assert rc == 0, rc
    frc, fwall, _, first = runs["first"]
    assert frc == "ToleranceError" and len(first) == EXPLICIT_STEPS
    return dict(
        case=dict(ctrl=EXPLICIT_CTRL, mesh=f"cylinder_omesh({ni}, {nj})",
                  stretch="1.15 ** (20 / nj)"),
        full=dict(exit=rc, wall_s=wall, steps=len(rows),
                  first_absres=rows[0]["absres"],
                  final_relres=rows[-1]["relres"],
                  functionals={k: out[k] for k in FUNCTIONALS}),
        first=dict(steps=EXPLICIT_STEPS, wall_s=fwall,
                   history=[dict(step=r["step"], relres=r["relres"],
                                 absres=r["absres"]) for r in first]))


def vortex():
    import jax.numpy as jnp
    import numpy as np
    from fvens_tpu.config import (BCSpec, NumericsConfig, PhysicsConfig)
    from fvens_tpu.fv.residual import FlowFV
    from fvens_tpu.mesh import compile_mesh
    from fvens_tpu.mesh.meshgen import _grid_mesh
    from fvens_tpu.physics import GasPhysics
    from fvens_tpu.solver.unsteady import TVDRKSolver
    from test_unsteady import vortex_state
    L, n = 10.0, VORTEX["n"]
    xs = np.linspace(0.0, L, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    md = _grid_mesh(X, Y, {"imin": 7, "imax": 7, "jmin": 8, "jmax": 8})
    cm = compile_mesh(md, [BCSpec(marker=7, type="periodic",
                                  periodic_axis=0),
                           BCSpec(marker=8, type="periodic",
                                  periodic_axis=1)])
    space = FlowFV(phy=GasPhysics(g=1.4, Minf=0.5),
                   pcfg=PhysicsConfig(Minf=0.5, viscous=False),
                   ncfg=NumericsConfig(flux="ROE", gradient="LEASTSQUARES",
                                       reconstruction="LINEAR", order2=True))
    rc = np.asarray(cm.rc)
    u0 = np.tile(vortex_state(np.zeros((1, 2)) + L, L / 2, L / 2),
                 (cm.NC, 1))
    u0[: cm.n_cells] = vortex_state(rc[: cm.n_cells], L / 2, L / 2)
    t0 = time.perf_counter()
    u, t, steps = TVDRKSolver(space, order=VORTEX["order"],
                              cfl=VORTEX["cfl"]).solve(
        cm, jnp.asarray(u0), VORTEX["final_time"])
    u = np.asarray(u)
    wall = time.perf_counter() - t0
    nc = cm.n_cells
    area = np.asarray(cm.area)[:nc]
    dx = (rc[:nc, 0] - (L / 2 + t) + L / 2) % L - L / 2
    uex = vortex_state(np.stack([dx, rc[:nc, 1]], axis=1), 0.0, L / 2)
    return dict(
        case=dict(mesh=f"{n}x{n} periodic box [0, {L}]^2",
                  flux="ROE", gradient="LEASTSQUARES",
                  reconstruction="LINEAR", **VORTEX),
        wall_s=wall, steps=steps, t=t,
        mass0=float((u0[:nc, 0] * area).sum()),
        mass=float((u[:nc, 0] * area).sum()),
        l2_error=float(np.sqrt(((u[:nc, 0] - uex[:, 0]) ** 2 * area).sum())),
        l2_vortex=float(np.sqrt(((u0[:nc, 0] - 1.0) ** 2 * area).sum())),
        state_shape=list(u.shape),
        state_f64_base64=base64.b64encode(
            np.ascontiguousarray(u, dtype="<f8").tobytes()).decode())


def heat():
    from test_heat import solve_one
    t0 = time.perf_counter()
    out = dict(implicit=[dict(n=n, tri=tri, l2_error=solve_one(n, tri))
                         for tri in (True, False) for n in HEAT_N],
               explicit=[dict(n=8, tri=False,
                              l2_error=solve_one(8, False, implicit=False))])
    out["wall_s"] = time.perf_counter() - t0
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "records",
                                                  "jax_schemes_history.json"))
    ap.add_argument("--only", default="naca,explicit,vortex,heat",
                    help="comma-separated parts to (re)make; the others are "
                         "kept from the existing record")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    rec = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            rec = json.load(f)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for part in args.only.split(","):
            rec[part] = {"naca": lambda: naca(tmp),
                         "explicit": lambda: explicit(tmp),
                         "vortex": vortex, "heat": heat}[part]()
    rec["host"] = dict(machine=platform.machine(), cpus=os.cpu_count(),
                       python=platform.python_version(),
                       jax=jax.__version__, parts=args.only,
                       wall_s=time.perf_counter() - t0)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
