"""The JAX package's banded heat solve, recorded.

    JAX_PLATFORMS=cpu python records/jax_heat_banded_history.py [--out FILE]
        [--n 16,256,512]

Runs fvens_tpu's SteadyBackwardEuler on the heat problem of
tests/test_heat.py (DiffusionFV, nu = 1, the manufactured source, Dirichlet
0 on unit_square(n) quads, from u = 0) with the banded operators:
LinearSolverConfig(maxiter=60, restart=60, rtol=1e-4, banded=True,
pc="bsgs", pc_sweeps=6), implicit CFL 1e4 to a relative residual of 1e-9,
at most 300 steps, full update. The system has 1x1 blocks (V = 1) and f64
values, so the JAX package takes its XLA banded operators
(solver/banded.py; its Pallas kernels take f32 4x4 blocks only). At
n = 512 (262,144 cells) its GMRES runs blocked by itself.

The inputs are those of tests/test_torch_steppers.py's banded heat test,
and fvens_tpu_torch's `cases.model_problems.heat_solve(dev, n, False,
banded=True, pc="bsgs", pc_sweeps=6)` is the same solve in the port.

On the CPU with x64. Writes records/jax_heat_banded_history.json: per n the
band offsets, accepted steps, Krylov iterations (in all and per step), the
per-step relative and absolute residuals, whether it converged, the L2
error against the exact solution and the wall time; then the L2 error
order between the last two n.
"""

import argparse
import json
import math
import os
import platform
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

LIN = dict(maxiter=60, restart=60, rtol=1e-4, banded=True, pc="bsgs",
           pc_sweeps=6)
PSEUDO = dict(cfl_init=1e4, cfl_fin=1e4, tol=1e-9, maxiter=300)


class _History:
    def __init__(self):
        self.rows = []

    def log(self, step, relres, absres, lin_iters=0, cfl=0.0, **_):
        self.rows.append(dict(step=int(step), relres=float(relres),
                              absres=float(absres),
                              krylov_iters=int(lin_iters)))


def run(n: int) -> dict:
    import jax.numpy as jnp
    from fvens_tpu.config import (BCSpec, LinearSolverConfig,
                                  NonlinearUpdateConfig, PseudoTimeConfig)
    from fvens_tpu.fv.diffusion import DiffusionFV
    from fvens_tpu.mesh import compile_mesh
    from fvens_tpu.mesh.meshgen import unit_square
    from fvens_tpu.solver.steady import SteadyBackwardEuler
    from test_heat import exact, source

    cm = compile_mesh(unit_square(n),
                      [BCSpec(marker=1, type="dirichlet", values=(0.0,))])
    solver = SteadyBackwardEuler(
        DiffusionFV(diffusivity=1.0, source=source),
        PseudoTimeConfig(**PSEUDO), LinearSolverConfig(**LIN),
        NonlinearUpdateConfig(scheme="full"))
    bl = solver._banded(cm)
    if bl is None:
        raise RuntimeError(f"unit_square({n}) is not band-coverable")
    log = _History()
    t0 = time.perf_counter()
    u, info = solver.solve(cm, jnp.zeros((cm.NC, 1)), logger=log)
    wall = time.perf_counter() - t0
    nc = cm.n_cells
    rc, area = np.asarray(cm.rc)[:nc], np.asarray(cm.area)[:nc]
    err = np.asarray(u)[:nc, 0] - exact(rc)
    return dict(n=n, cells=int(nc), NC=int(cm.NC),
                offsets=[int(d) for d in bl.offsets],
                steps=int(info.steps),
                krylov_iters=int(info.total_lin_iters),
                converged=bool(info.converged),
                initres=float(info.initres), finalres=float(info.finalres),
                l2_error=float(np.sqrt((err ** 2 * area).sum())),
                history=log.rows, wall_s=wall)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "records", "jax_heat_banded_history.json"))
    ap.add_argument("--n", default="16,256,512",
                    help="comma-separated unit_square sizes")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    t0 = time.perf_counter()
    runs = []
    for n in (int(s) for s in args.n.split(",")):
        runs.append(run(n))
        r = runs[-1]
        print(f"n={n}: {r['steps']} steps, {r['krylov_iters']} Krylov "
              f"iterations, L2 error {r['l2_error']!r}, {r['wall_s']:.1f} s",
              flush=True)
    rec = dict(case=dict(linear=LIN, pseudotime=PSEUDO, update="full",
                         mesh="unit_square(n) quads", dtype="float64"),
               runs=runs)
    if len(runs) >= 2:
        a, b = runs[-2], runs[-1]
        rec["order"] = math.log2(a["l2_error"] / b["l2_error"]) / math.log2(
            b["n"] / a["n"])
    rec["host"] = dict(machine=platform.machine(), cpus=os.cpu_count(),
                       python=platform.python_version(),
                       jax=jax.__version__,
                       wall_s=time.perf_counter() - t0)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
