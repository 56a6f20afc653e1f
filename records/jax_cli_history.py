"""The JAX package's CLI on the committed cylinder control file, recorded.

    JAX_PLATFORMS=cpu python records/jax_cli_history.py [--out FILE]

Writes cylinder_omesh(160, 80, stretch=1.15**(20/80)) with the JAX
package's write_gmsh2 into a temporary directory, then runs
`python -m fvens_tpu.cases.cli` in this process on the CPU with x64 (the
CLI's default f64) on fvens_tpu_torch/cases/ctrl/cylinder.ctrl with
`-options_file fvens_tpu_torch/cases/ctrl/cylinder.solverc`,
`--log_every 1`, `--functionals_every 10` and `--history`: the inviscid
cylinder at M 0.38 (HLLC, weighted least squares, no limiter), a
first-order starter (CFL 50 -> 1000 to 1e-1), then the second-order main
solve (CFL 500 -> 5000 to 1e-10 of its first residual), FGMRES(90) at a
fixed rtol of 1e-2 with bjacobi + ILU, which the solverc mapping makes six
block-Jacobi sweeps on slot gathers (bsgs x6).

Writes records/jax_cli_history.json: the command, the mesh, the starter's
steps and Krylov iterations (from its printed monitor lines), the main
solve's per-step relres, absres, CFL and Krylov iterations (from the JSONL
history), its totals, the functionals logged every 10 steps, and the
converged entropy error, CL, CDp and CDsf as the CLI prints them.
"""

import argparse
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

from chip_smoke import FUNCTIONALS, parse_cli_output  # noqa: E402

MESH = (160, 80)
CTRL = "fvens_tpu_torch/cases/ctrl/cylinder.ctrl"
SOLVERC = "fvens_tpu_torch/cases/ctrl/cylinder.solverc"
FUNCTIONALS_EVERY = 10


def read_history(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "records",
                                                  "jax_cli_history.json"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from fvens_tpu.cases import cli
    from fvens_tpu.cases.convertformat import write_gmsh2
    from fvens_tpu.mesh.meshgen import cylinder_omesh

    ni, nj = MESH
    with tempfile.TemporaryDirectory() as tmp:
        msh = os.path.join(tmp, f"cylinder-{ni}x{nj}.msh")
        write_gmsh2(msh, cylinder_omesh(ni, nj, stretch=1.15 ** (20.0 / nj)))
        hist = os.path.join(tmp, "history.jsonl")
        argv = [os.path.join(ROOT, CTRL), "--mesh_file", msh,
                "-options_file", os.path.join(ROOT, SOLVERC),
                "--platform", "cpu", "--log_every", "1",
                "--functionals_every", str(FUNCTIONALS_EVERY),
                "--history", hist]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        print(text)
        if rc != 0:
            raise SystemExit(f"the CLI exited {rc}")
        rows = read_history(hist)
    out = parse_cli_output(text)
    starter = out["starter_iters"]
    main_rec = dict(
        steps=len(rows), krylov_iters=sum(r["lin_iters"] for r in rows),
        history=[dict(step=r["step"], relres=r["relres"],
                      absres=r["absres"], cfl=r["cfl"],
                      lin_iters=r["lin_iters"]) for r in rows],
        functionals_logged=[{k: r[k] for k in ("step",) + FUNCTIONALS}
                            for r in rows if "CL" in r])
    assert (main_rec["steps"], main_rec["krylov_iters"]) \
        == (out["main_steps"], out["main_iters"])
    with open(args.out, "w") as f:
        json.dump(dict(
            case=dict(ctrl=CTRL, solverc=SOLVERC,
                      mesh=f"cylinder_omesh({ni}, {nj})",
                      stretch="1.15 ** (20 / nj)",
                      argv=["python -m fvens_tpu.cases.cli", CTRL,
                            "--mesh_file", "<mesh>", "-options_file",
                            SOLVERC, "--platform", "cpu", "--log_every", "1",
                            "--functionals_every", str(FUNCTIONALS_EVERY),
                            "--history", "<history>"]),
            host=dict(machine=platform.machine(), cpus=os.cpu_count(),
                      python=platform.python_version(),
                      jax=jax.__version__, wall_s=wall),
            starter=dict(steps=len(starter), krylov_iters=sum(starter),
                         lin_iters=starter),
            main=main_rec,
            functionals={k: out[k] for k in FUNCTIONALS}), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
