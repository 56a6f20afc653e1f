"""The port's control-file entry point against the JAX package's.

Both CLIs run in this process on the CPU at f64 (`--device cpu`,
`--platform cpu`) on the committed cylinder ctrl and solverc
(fvens_tpu_torch/cases/ctrl/) with the main tolerance tightened to 1e-12,
so that the main solve passes step 50 and writes a checkpoint, on
cylinder_omesh(24, 10) written by the port's write_gmsh2, with every
output. They must give:

  - the same starter: steps and Krylov iterations per step;
  - the first 30 main steps step for step: equal Krylov iterations and
    residuals to 1e-9 relative, with a floor of 1e-12 of the first main
    residual (rounding differences grow as the residual falls: the
    relative gap reaches about 2e-7 by step 30, 4e-14 of the first
    residual), and the totals within 10% (ROADMAP, "Knife-edge
    trajectories");
  - converged entropy, CL, CDp and CDsf to 1e-8 (CL, zero by symmetry,
    to 1e-12 absolute);
  - JSONL histories with the same keys and Krylov iterations per line;
  - VTU, surface and volume arrays to 1e-10.

The port's rerun with the same --checkpoint resumes from it. A missing mesh
exits 1; --pipeline is refused; --devices 2 --device cpu (two gloo ranks)
runs what the JAX CLI's --devices 2 runs (DistributedFlowCase.run_output
on two virtual CPU devices); unsteady and explicit control files print
what the JAX CLI prints; the CLI module imports with jax blocked. Also:
the perftest breakdown and the torch twin of __graft_entry__.entry().
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from chip_smoke import FUNCTIONALS, parse_cli_output
from fvens_tpu.cases import cli as jax_cli
from fvens_tpu_torch.cases import cli
from fvens_tpu_torch.cases.convertformat import write_gmsh2
from fvens_tpu_torch.mesh.meshgen import cylinder_omesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTRL_DIR = os.path.join(ROOT, "fvens_tpu_torch", "cases", "ctrl")
SOLVERC = os.path.join(CTRL_DIR, "cylinder.solverc")
MESH = (24, 10)
MAIN_TOL = "1e-12"
AGREE = 30


def _ctrl(tmp, **subs):
    """The committed cylinder ctrl with its main tolerance MAIN_TOL and the
    other replacements `subs` (old text: new text)."""
    with open(os.path.join(CTRL_DIR, "cylinder.ctrl")) as f:
        text = f.read()
    assert "tolerance      1e-10" in text
    text = text.replace("tolerance      1e-10", f"tolerance      {MAIN_TOL}")
    for old, new in subs.items():
        assert old in text
        text = text.replace(old, new)
    path = os.path.join(tmp, f"case{len(os.listdir(tmp))}.ctrl")
    with open(path, "w") as f:
        f.write(text)
    return path


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _vtu_arrays(path):
    piece = ET.parse(path).getroot().find("UnstructuredGrid/Piece")
    return {a.get("Name") or f"points{i}": np.asarray(a.text.split(),
                                                      dtype=float)
            for i, a in enumerate(piece.iter("DataArray"))}, piece


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cli"))
    msh = os.path.join(tmp, "cylinder.msh")
    write_gmsh2(msh, cylinder_omesh(*MESH, stretch=1.15 ** (20.0 / MESH[1])))
    ctrl = _ctrl(tmp)
    out = {}
    for name, main, dev in (("jax", jax_cli.main, ["--platform", "cpu"]),
                            ("port", cli.main, ["--device", "cpu"])):
        p = {k: os.path.join(tmp, f"{name}.{k}") for k in
             ("vtu", "surface", "volume", "history", "npz")}
        argv = [ctrl, "--mesh_file", msh, "-options_file", SOLVERC,
                "--log_every", "1", "--functionals_every", "10",
                "--vtu", p["vtu"], "--surface", p["surface"],
                "--volume", p["volume"], "--history", p["history"],
                "--checkpoint", p["npz"]] + dev
        rc, text = _run(main, argv)
        assert rc == 0, text
        out[name] = dict(text=text, paths=p, argv=argv,
                         rows=_jsonl(p["history"]), **parse_cli_output(text))
    out["tmp"], out["msh"] = tmp, msh
    return out


def test_cli_starter_and_main_steps_match_jax(runs):
    j, t = runs["jax"], runs["port"]
    assert t["starter_iters"] == j["starter_iters"]
    assert len(t["starter_iters"]) > 0
    jr, tr = j["rows"], t["rows"]
    assert len(jr) > 50 and len(tr) > 50        # a checkpoint was written
    first = jr[0]["absres"]
    for a, b in zip(tr[:AGREE], jr[:AGREE]):
        assert a["step"] == b["step"]
        assert a["lin_iters"] == b["lin_iters"], a["step"]
        assert abs(a["absres"] - b["absres"]) \
            <= 1e-9 * b["absres"] + 1e-12 * first, a["step"]
        assert abs(a["cfl"] - b["cfl"]) <= 1e-9 * b["cfl"]
    for key in ("steps", "iters"):
        got = len(tr) if key == "steps" else sum(r["lin_iters"] for r in tr)
        want = len(jr) if key == "steps" else sum(r["lin_iters"] for r in jr)
        assert abs(got - want) <= 0.1 * want, key
    assert tr[-1]["relres"] <= float(MAIN_TOL)
    assert re.search(rf"solved in {len(tr)} steps, "
                     rf"{sum(r['lin_iters'] for r in tr)} linear", t["text"])


def test_cli_functionals_match_jax(runs):
    j, t = runs["jax"], runs["port"]
    for k in FUNCTIONALS:
        assert abs(t[k] - j[k]) <= max(1e-8 * abs(j[k]), 1e-12), k
    assert t["CDp"] > 0 and t["CDsf"] > 0 and t["entropy"] > 0


def test_cli_histories_have_the_jax_schema(runs):
    jr, tr = runs["jax"]["rows"], runs["port"]["rows"]
    for a, b in zip(tr, jr):
        assert list(a) == list(b), a["step"]
    logged = [r["step"] for r in tr if "CL" in r]
    assert logged == [r["step"] for r in jr if "CL" in r]
    assert logged == [s for s in range(1, len(tr) + 1) if s % 10 == 0]
    for a, b in zip(tr, jr):
        if "CL" in a:
            for k in FUNCTIONALS:
                assert abs(a[k] - b[k]) <= 1e-6 * abs(b[k]) + 1e-12, k


def test_cli_output_files_match_jax(runs):
    jp, tp = runs["jax"]["paths"], runs["port"]["paths"]
    ja, jpiece = _vtu_arrays(jp["vtu"])
    ta, tpiece = _vtu_arrays(tp["vtu"])
    assert tpiece.attrib == jpiece.attrib
    assert int(tpiece.get("NumberOfCells")) == MESH[0] * MESH[1]
    assert list(ta) == list(ja)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-10, atol=1e-10,
                                   err_msg=k)
    for k in ("surface", "volume"):
        a, b = np.loadtxt(tp[k]), np.loadtxt(jp[k])
        assert a.shape == b.shape and a.shape[0] > 0
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10, err_msg=k)
    assert np.loadtxt(tp["surface"]).shape == (MESH[0], 4)


def test_cli_rerun_resumes_from_the_checkpoint(runs):
    t = runs["port"]
    rc, text = _run(cli.main, t["argv"])
    assert rc == 0
    assert f"resumed from {t['paths']['npz']} at step 50" in text
    again = parse_cli_output(text)
    for k in FUNCTIONALS:
        assert abs(again[k] - t[k]) <= max(1e-8 * abs(t[k]), 1e-12), k


def test_cli_resumes_from_the_jax_checkpoint(runs):
    """The JAX CLI's checkpoint resumes in the port's CLI."""
    t = runs["port"]
    argv = list(t["argv"])
    argv[argv.index("--checkpoint") + 1] = runs["jax"]["paths"]["npz"]
    argv[argv.index("--history") + 1] = os.path.join(runs["tmp"], "x.jsonl")
    rc, text = _run(cli.main, argv)
    assert rc == 0 and "resumed from" in text
    again = parse_cli_output(text)
    for k in FUNCTIONALS:
        assert abs(again[k] - t[k]) <= max(1e-8 * abs(t[k]), 1e-12), k


def test_cli_missing_mesh_exits_1(capsys):
    rc = cli.main([os.path.join(CTRL_DIR, "cylinder.ctrl"), "--mesh_file",
                   "/nonexistent.msh", "--device", "cpu"])
    assert rc == 1
    err = capsys.readouterr().err
    assert err.strip() == "fvens_tpu_torch: mesh file not found: " \
        "/nonexistent.msh"


def test_cli_needs_the_card_unless_told(runs, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would run on it")
    rc = cli.main([os.path.join(CTRL_DIR, "cylinder.ctrl"), "--mesh_file",
                   runs["msh"]])
    assert rc == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("refusal", ["unsteady", "devices", "pipeline",
                                     "explicit"])
def test_cli_refuses_unported_paths(runs, refusal):
    """--pipeline is refused. --devices, refused until the distributed
    path was ported, and unsteady and explicit control files, refused
    until their steppers were, now run and print what the JAX CLI prints
    on the same files:
      - the cylinder ctrl and solverc (main to 1e-12) with --devices 2: the
        port's two gloo ranks (--device cpu; the CLI run in a subprocess,
        whose ranks write to its standard output) against the JAX CLI's
        DistributedFlowCase.run_output on two virtual CPU devices: equal
        starter steps, the first AGREE main steps step for step (equal
        Krylov iterations, residuals to 1e-9 relative with a floor of
        1e-12 of the first), totals within 10%, functionals to 1e-8 (CL,
        zero by symmetry, to 1e-12 absolute);
      - the cylinder ctrl made unsteady (TVD-RK2 at physical CFL 0.4 to
        t = 0.05) and made explicit (forward Euler at CFL 0.8: the starter
        to its 1e-1, the main solve to half its first residual): the same
        steps, and the functionals to 1e-10."""
    tmp, msh = runs["tmp"], runs["msh"]
    argv = ["--mesh_file", msh, "--log_every", "1"]
    if refusal == "pipeline":
        with pytest.raises(NotImplementedError, match="pipelined"):
            _run(cli.main, [_ctrl(tmp)] + argv + ["--pipeline", "--device",
                                                  "cpu"])
        return
    if refusal == "devices":
        ctrl = _ctrl(tmp)
        argv += ["-options_file", SOLVERC, "--devices", "2", "--history"]
        hist = {k: os.path.join(tmp, f"devices_{k}.jsonl")
                for k in ("jax", "port")}
        rc, jtext = _run(jax_cli.main, [ctrl] + argv + [
            hist["jax"], "--platform", "cpu"])
        assert rc == 0, jtext
        proc = subprocess.run(
            [sys.executable, "-m", "fvens_tpu_torch.cases.cli", ctrl] + argv
            + [hist["port"], "--device", "cpu"], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "2 ranks (gloo)" in proc.stdout
        j, t = parse_cli_output(jtext), parse_cli_output(proc.stdout)
        starter = re.compile(r"^\s*dBE \|\s+\d+ \|[^|]+\|[^|]+\|\s+(\d+) \|",
                             re.M)
        assert starter.findall(proc.stdout) == starter.findall(jtext) != []
        jr, tr = _jsonl(hist["jax"]), _jsonl(hist["port"])
        first = jr[0]["absres"]
        for a, b in zip(tr[:AGREE], jr[:AGREE]):
            assert a["lin_iters"] == b["lin_iters"], a["step"]
            assert abs(a["absres"] - b["absres"]) \
                <= 1e-9 * b["absres"] + 1e-12 * first, a["step"]
        for key in ("main_steps", "main_iters"):
            assert abs(t[key] - j[key]) <= 0.1 * j[key], key
        assert (t["main_steps"], t["main_iters"]) == (
            len(tr), sum(r["lin_iters"] for r in tr))
        for k in FUNCTIONALS:
            assert abs(t[k] - j[k]) <= max(1e-8 * abs(j[k]), 1e-12), k
        return
    argv[-1] = "0"
    if refusal == "unsteady":
        ctrl = _ctrl(tmp, **{"simulation_type  steady":
                             "simulation_type  unsteady\n\tfinal_time 0.05"
                             "\n\ttemporal_order 2\n\tphysical_cfl 0.4"})
    else:
        ctrl = _ctrl(tmp, **{
            "pseudotime_stepping_type  implicit":
            "pseudotime_stepping_type  explicit",
            "cfl_min        500": "cfl_min        0.8",
            "cfl_min        50\n": "cfl_min        0.8\n",
            f"tolerance      {MAIN_TOL}": "tolerance      5e-1",
            "max_timesteps  200": "max_timesteps  20000"})
    out = {}
    for name, main, dev in (("jax", jax_cli.main, ["--platform", "cpu"]),
                            ("port", cli.main, ["--device", "cpu"])):
        rc, text = _run(main, [ctrl] + argv + dev)
        assert rc == 0, text
        out[name] = dict(parse_cli_output(text), text=text)
    j, t = out["jax"], out["port"]
    assert t["main_steps"] == j["main_steps"] > 1
    assert t["main_iters"] == j["main_iters"] == 0
    if refusal == "unsteady":
        line = re.compile(r"unsteady TVDRK2 to t=0.05 in (\d+) steps")
        assert line.search(t["text"]).group(1) \
            == line.search(j["text"]).group(1) == str(j["main_steps"])
    for k in FUNCTIONALS:
        assert abs(t[k] - j[k]) <= max(1e-10 * abs(j[k]), 1e-12), k


def test_cli_and_new_modules_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import fvens_tpu_torch.cases.cli, fvens_tpu_torch.cases.perftest\n"
        "import fvens_tpu_torch.cases.convertformat, fvens_tpu_torch.entry\n"
        "import fvens_tpu_torch.io_config.logs\n"
        "import fvens_tpu_torch.io_config.checkpoint\n"
        "import fvens_tpu_torch.io_config.solverc\n"
        "import fvens_tpu_torch.mesh.ordering, fvens_tpu_torch.output\n"
        "import fvens_tpu_torch.cases.model_problems\n"
        "import fvens_tpu_torch.fv.diffusion, fvens_tpu_torch.solver.unsteady\n"
        "import fvens_tpu_torch.solver.ilu, fvens_tpu_torch.solver.lines\n"
        "import fvens_tpu_torch.solver.multigrid\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and (m.split('.')[0] in ('fvens_tpu', 'jax'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_perftest_breakdown_runs_on_the_host(runs, capsys):
    from fvens_tpu_torch.cases import perftest
    assert perftest.main([_ctrl(runs["tmp"]), "--mesh_file", runs["msh"],
                          "--device", "cpu", "--breakdown",
                          "--repeats", "1"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["kernel"] for r in recs] == ["residual", "jacobian_assembly",
                                           "pc_apply", "bsr_matvec"]
    assert all(r["ms"] > 0 and r["cells"] == MESH[0] * MESH[1]
               for r in recs)


def test_entry_matches_the_jax_entry():
    """fvens_tpu_torch.entry.entry() is __graft_entry__.entry(): the
    flagship residual and local steps on naca0012_omesh(96, 32), at f32
    (to 1e-4 of the largest magnitude plus 2e-5: at free stream the
    residual is a cancellation of fluxes of order one, whose f32 rounding
    it keeps) and at f64 (to 1e-12 of the largest magnitude)."""
    import __graft_entry__
    import jax
    import jax.numpy as jnp
    from fvens_tpu.cases.casesolvers import initial_state as jinit
    from fvens_tpu_torch import entry
    for dtype, jdtype, tol, atol in ((torch.float32, jnp.float32, 1e-4, 2e-5),
                                     (torch.float64, jnp.float64, 1e-12, 0)):
        fn, (u0,) = entry.entry(device="cpu", dtype=dtype)
        assert u0.dtype == dtype and u0.device.type == "cpu"
        _, _, jmesh, jspace = __graft_entry__._flagship(jdtype)
        ju0 = jinit(jspace, jmesh)
        np.testing.assert_array_equal(u0.numpy(), np.asarray(ju0))
        rhs, dt = fn(u0)
        jrhs, jdt = jax.jit(
            lambda m, u: jspace.compute_residual(m, u, True))(jmesh, ju0)
        for got, want in ((rhs, jrhs), (dt, jdt)):
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() \
                <= tol * np.abs(want).max() + atol
    if torch.cuda.is_available():
        assert entry.entry()[1][0].is_cuda


def test_jax_cli_record_is_the_committed_case():
    """records/jax_cli_history.json, which chip_smoke.py holds the card's
    160x80 CLI run to, records the committed ctrl and solverc on
    chip_smoke.CHECK_MESH and is self-consistent."""
    import chip_smoke
    from fvens_tpu_torch.io_config import parse_control_file
    with open(os.path.join(ROOT, chip_smoke.JAX_CLI_RECORD)) as f:
        rec = json.load(f)
    case = rec["case"]
    assert (case["ctrl"], case["solverc"]) == (chip_smoke.CLI_CTRL,
                                               chip_smoke.CLI_SOLVERC)
    assert case["mesh"] == "cylinder_omesh({}, {})".format(
        *chip_smoke.CHECK_MESH)
    st, main = rec["starter"], rec["main"]
    assert st["steps"] == len(st["lin_iters"]) > 0
    assert st["krylov_iters"] == sum(st["lin_iters"])
    hist = main["history"]
    assert [h["step"] for h in hist] == list(range(1, main["steps"] + 1))
    assert main["krylov_iters"] == sum(h["lin_iters"] for h in hist)
    tol = parse_control_file(os.path.join(ROOT, case["ctrl"])).main.tol
    assert hist[-1]["relres"] <= tol < hist[-2]["relres"]
    assert main["steps"] > 50 >= chip_smoke.AGREE_STEPS
    assert [r["step"] for r in main["functionals_logged"]] == list(
        range(10, main["steps"] + 1, 10))
    assert all(np.isfinite(rec["functionals"][k]) for k in FUNCTIONALS)
