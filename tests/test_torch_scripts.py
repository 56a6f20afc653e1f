"""The port's post-processing scripts (fvens_tpu_torch/scripts) against the
JAX package's (fvens_tpu/scripts), the twin of tests/test_scripts.py.

  - each of the seven scripts of both packages runs on the same seeded
    inputs, each in a directory of its own with the same relative output
    path: their standard output is the same text, each writes its figure
    (or table, equal in both), and each returns 0;
  - plotconv and plotsurfdata also read files the port itself writes: a
    short ConvergenceLogger record (the CLI's --history), which has the
    JAX package's keys and values, wall times aside, and the --surface
    table of output.py on cylinder_omesh(24, 10), which has the JAX
    package's header, shape and values (to 1e-12 of the largest);
  - `python -m fvens_tpu_torch.scripts.<name> --help` works for each, and
    importing the package and a script pulls in neither matplotlib, nor
    torch, nor jax.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvens_tpu.scripts as jax_scripts
import fvens_tpu_torch.scripts as torch_scripts
from fvens_tpu import output as jout
from fvens_tpu.io_config.logs import ConvergenceLogger as JaxLogger
from fvens_tpu_torch import output as tout
from fvens_tpu_torch.io_config.logs import ConvergenceLogger

from test_torch_output import _case as output_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("computespeedup", "plotconv", "ploterr", "plotprecinfo",
         "plotstrongscale", "plotsurfdata", "plotwalltimes")


def _script(pkg, name):
    import importlib
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _history(path, g, n=12):
    with open(path, "w") as f:
        res = 1.0
        for step in range(1, n + 1):
            res *= float(g.uniform(0.2, 0.9))
            f.write(json.dumps(dict(step=step, relres=res, absres=0.3 * res,
                                    lin_iters=int(g.integers(5, 60)),
                                    cfl=50.0 * step,
                                    wall_s=0.1 * step)) + "\n")


def _inputs(name, d):
    """Seeded inputs of `name` in directory d; returns (argv, outputs)."""
    g = np.random.default_rng(NAMES.index(name))
    p = lambda f: os.path.join(d, f)            # noqa: E731
    if name == "computespeedup":
        t = 100.0 / np.array([1, 1.9, 3.6, 6.5]) * g.uniform(0.9, 1.1, 4)
        np.savetxt(p("times.dat"), np.column_stack([[1, 2, 4, 8], t]))
        return [p("times.dat"), "--out", "speedup.dat"], ["speedup.dat"]
    if name == "plotconv":
        _history(p("h1.jsonl"), g)
        _history(p("h2.jsonl"), g, 20)
        return [p("h1.jsonl"), p("h2.jsonl"), "--out", "c.png", "--y",
                "absres"], ["c.png"]
    if name == "ploterr":
        h = np.array([0.1, 0.05, 0.025, 0.0125])
        np.savetxt(p("errs.dat"), np.column_stack(
            [h, 0.7 * h ** 2 * g.uniform(0.9, 1.1, 4)]))
        return [p("errs.dat"), "--out", "e.png"], ["e.png"]
    if name == "plotprecinfo":
        with open(p("prec.jsonl"), "w") as f:
            for pc, sw in (("bsgs", 6), ("bcsgs", 3), ("bjacobi", 1)):
                w = float(g.uniform(5, 15))
                f.write(json.dumps({"pc": pc, "sweeps": sw, "krylov": 60,
                                    "avg_wall_s": w, "min_wall_s": w,
                                    "steps": 40, "total_lin_iters":
                                    int(g.integers(200, 900))}) + "\n")
            f.write("# best: {}\n")
        return [p("prec.jsonl"), "--out", "p.png"], ["p.png"]
    if name == "plotstrongscale":
        t = 60.0 / np.array([1, 1.8, 3.2, 5.5]) * g.uniform(0.9, 1.1, 4)
        np.savetxt(p("scale.dat"), np.column_stack([[1, 2, 4, 8], t]),
                   header="devices wall_s")
        return [p("scale.dat"), "--out", "sc.png"], ["sc.png"]
    if name == "plotsurfdata":
        x = np.linspace(0.0, 1.0, 24)
        np.savetxt(p("surf.dat"), np.column_stack(
            [x, 0.1 * np.sin(np.pi * x), g.standard_normal(24),
             1e-3 * g.random(24)]), header="x y Cp Cf")
        return [p("surf.dat"), "--out", "s.png", "--qty", "cf"], ["s.png"]
    with open(p("walls.dat"), "w") as f:                 # plotwalltimes
        f.write("# label wall_s\n")
        for lab in ("gather", "banded"):
            f.write(f"{lab} {g.uniform(1, 20):.6f} 3\n")
        f.write(json.dumps({"label": "dist", "wall_s": 7.5}) + "\n")
    return [p("walls.dat"), "--out", "w.png"], ["w.png"]


def _run_both(tmp_path, monkeypatch, capsys, name, argv, outputs):
    """Runs `name` of each package in its own directory; returns the two
    stdouts after checking the return codes and outputs."""
    outs = []
    for pkg in (jax_scripts, torch_scripts):
        d = tmp_path / pkg.__name__
        d.mkdir()
        monkeypatch.chdir(d)
        capsys.readouterr()
        assert _script(pkg, name).main(list(argv)) == 0
        outs.append(capsys.readouterr().out)
        for f in outputs:
            assert (d / f).exists() and (d / f).stat().st_size > 0, f
    for f in outputs:
        if f.endswith(".dat"):
            assert (tmp_path / jax_scripts.__name__ / f).read_text() == \
                (tmp_path / torch_scripts.__name__ / f).read_text()
    return outs


@pytest.mark.parametrize("name", NAMES)
def test_script_matches_jax(tmp_path, monkeypatch, capsys, name):
    src = tmp_path / "inputs"
    src.mkdir()
    argv, outputs = _inputs(name, str(src))
    jax_out, torch_out = _run_both(tmp_path, monkeypatch, capsys, name, argv,
                                   outputs)
    assert torch_out == jax_out
    assert torch_out.strip()


def test_plotconv_reads_the_port_history(tmp_path, monkeypatch, capsys):
    """The port's logger writes the JAX logger's records (the same keys,
    functionals included; wall times aside), and plotconv of either
    package reads them alike."""
    g = np.random.default_rng(11)
    rows = [dict(step=s, relres=float(r), absres=float(r) * 0.4,
                 lin_iters=int(i), cfl=25.0 * s)
            for s, r, i in zip(range(1, 9), np.cumprod(g.uniform(.2, .9, 8)),
                               g.integers(3, 90, 8))]
    paths = {}
    for name, cls in (("jax", JaxLogger), ("torch", ConvergenceLogger)):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        log = cls(paths[name], print_every=0)
        for r in rows:
            extra = ({"entropy": 1e-3 / r["step"], "CL": 0.01}
                     if r["step"] % 4 == 0 else {})
            log.log(**r, **extra)
        log.close()
    recs = {k: [json.loads(line) for line in open(p)]
            for k, p in paths.items()}
    assert len(recs["torch"]) == len(rows)
    for a, b in zip(recs["jax"], recs["torch"]):
        assert list(a) == list(b)
        a.pop("wall_s"), b.pop("wall_s")
        assert a == b
    jl = _script(jax_scripts, "plotconv").load_history(paths["torch"])
    tl = _script(torch_scripts, "plotconv").load_history(paths["torch"])
    for key in ("step", "relres", "absres"):
        assert tl[key] == jl[key] == [r[key] for r in rows]
    jax_out, torch_out = _run_both(
        tmp_path, monkeypatch, capsys, "plotconv",
        [paths["torch"], "--out", "conv.png", "--x", "wall_s"], ["conv.png"])
    assert torch_out == jax_out == "wrote conv.png\n"


@pytest.mark.parametrize("qty", ["cp", "cf"])
def test_plotsurfdata_reads_the_port_surface_table(tmp_path, monkeypatch,
                                                   capsys, qty):
    """output.py's --surface table on the inviscid cylinder at
    cylinder_omesh(24, 10): the JAX CLI's header and columns, the JAX
    package's values; plotsurfdata of either package reads it alike."""
    cfg, jm, tm, js, ts, u, _ = output_case("cylinder inviscid")
    jt, _ = jout.surface_data(js, jm, jnp.asarray(u), cfg.wall_markers)
    tt, _ = tout.surface_data(ts, tm, torch.from_numpy(u), cfg.wall_markers)
    jpath, tpath = str(tmp_path / "jax.dat"), str(tmp_path / "torch.dat")
    np.savetxt(jpath, np.asarray(jt), header="x y Cp Cf")   # the JAX CLI's
    tout.write_surface_table(tpath, tt)
    jlines, tlines = open(jpath).readlines(), open(tpath).readlines()
    assert tlines[0] == jlines[0] == "# x y Cp Cf\n"
    assert len(tlines) == len(jlines) == 24 + 1
    a, b = np.loadtxt(jpath), np.loadtxt(tpath)
    assert a.shape == b.shape == (24, 4)
    assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max()
    jax_out, torch_out = _run_both(
        tmp_path, monkeypatch, capsys, "plotsurfdata",
        [tpath, "--out", "surf.png", "--qty", qty], ["surf.png"])
    assert torch_out == jax_out == "wrote surf.png\n"


def test_help_and_imports():
    """--help of every script; importing the package and the scripts pulls
    in none of matplotlib, torch and jax."""
    for name in NAMES:
        r = subprocess.run([sys.executable, "-m",
                            f"fvens_tpu_torch.scripts.{name}", "--help"],
                           cwd=ROOT, capture_output=True, text=True)
        assert r.returncode == 0 and r.stdout.startswith("usage:"), name
    code = ("import sys, fvens_tpu_torch; "
            + "; ".join(f"import fvens_tpu_torch.scripts.{n}" for n in NAMES)
            + "; print(sorted(m for m in ('matplotlib', 'torch', 'jax') "
              "if m in sys.modules))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0 and r.stdout.strip() == "[]", r.stderr
