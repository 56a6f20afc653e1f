"""The harness on the CPU: the manifest against the contract, every file
found by name, each cell end to end at a tiny size with a valid result
line, no JAX loaded, the faults that `correct` has to catch, and the
controls failing the limits. The run on a card is marked `gpu`."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import control, harness, run
from benchmark.tests.conftest import tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_manifest_keys_names_and_units():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MAN[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for c in MAN["configs"]:
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for name in CELLS:
        cell = harness.resolve_cell(name)
        mine = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in mine and len(mine) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            # the end-to-end metric it moves is one this cell reports
            assert m["moves"] in mine, (name, m["name"])


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_metric_files_declare_their_manifest_entry(metric):
    m = {x["name"]: x for x in MAN["per_layer"]}[metric]
    cell = harness.resolve_cell(m.get("workloads", CELLS)[0])
    mod = cell.metric_reader(metric)
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES, mod.BETTER) == (
        m["layer"], m["unit"], m["source"], m["moves"], m["better"])
    assert mod.WORKLOADS == m.get("workloads", CELLS)
    assert mod.read({"solves": [], "segments": [], "trace": None,
                     "operators": dict}) is None


def test_an_addition_is_found_by_name(tmp_path):
    """A new configuration, cell and metric added as files and manifest
    entries, with no edit to a file that is there."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads(json.dumps(MAN))
    cyl = harness.load_json(os.path.join(harness.BENCH_DIR, "configs",
                                         "cylinder-m038-640x320.json"))
    cfg = dict(cyl, name="cylinder-m038-320x160")
    cfg["mesh"] = dict(cyl["mesh"], nt=320, nr=160)
    bench = root / "benchmark"
    (bench / "configs" / "cylinder-m038-320x160.json").write_text(
        json.dumps(cfg))
    wl = harness.load_json(os.path.join(harness.BENCH_DIR, "workloads",
                                        "cyl640-solve.json"))
    wl["config"] = cfg["name"]
    (bench / "workloads" / "cyl320-solve.json").write_text(json.dumps(wl))
    (bench / "metrics" / "starter_steps.cyl320.py").write_text(
        'LAYER = "pseudo-time continuation"\nUNIT = "steps"\n'
        'SOURCE = "program_counter"\nBETTER = "lower"\n'
        'MOVES = "solve_s"\nWORKLOADS = ["cyl320-solve"]\n\n\n'
        'def read(obs):\n    return 7.0\n')
    man["configs"].append(dict(man["configs"][0], name=cfg["name"],
                               file="benchmark/configs/"
                               "cylinder-m038-320x160.json"))
    man["workloads"].append(dict(man["workloads"][0], name="cyl320-solve",
                                 config=cfg["name"]))
    for m in man["end_to_end"]:
        if "workloads" in m and "cyl640-solve" in m["workloads"]:
            m["workloads"].append("cyl320-solve")
    man["per_layer"].append(dict(man["per_layer"][0],
                                 name="starter_steps.cyl320",
                                 workloads=["cyl320-solve"]))
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = harness.resolve_cell("cyl320-solve", str(root), str(bench))
    assert cell.config["mesh"]["nt"] == 320
    assert cell.driver().Driver.window
    assert [m["name"] for m in cell.per_layer] == ["starter_steps.cyl320"]
    assert cell.metric_reader("starter_steps.cyl320").read({}) == 7.0
    assert {m["name"] for m in cell.end_to_end} == {
        "solve_s", "peak_mem_gib", "setup_s"}


def _rehearse(name, trace=0, seed=2 ** 31 + 977):
    args = argparse.Namespace(workload=name, seed=seed, seconds=0.0,
                              trace=trace)
    return run.run(args, cell=tiny_cell(name), device="cpu")


def _valid_line(result, name, trace):
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    cell = harness.resolve_cell(name)
    want = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    for k, v in line["metrics"].items():
        assert units[k] == v["unit"] and isinstance(v["value"], float)
    if not trace:
        assert set(line["metrics"]) == set(units)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    return line


@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearsal_on_the_cpu(name):
    line = _valid_line(_rehearse(name), name, 0)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1


def test_traced_rehearsal_on_the_cpu():
    line = _valid_line(_rehearse("naca640-cli-steps", trace=1),
                       "naca640-cli-steps", 1)
    assert line["correct"] is True
    # counts only: no device metric is read on the CPU
    assert set(line["metrics"]) == {"krylov_per_step.naca"}
    assert "breakdown" in line


def test_no_jax_in_what_runs():
    """A cell's rehearsal in a fresh interpreter loads no module whose
    top-level name is jax, jaxlib, flax or fvens_tpu (fvens_tpu_torch
    passes: names are compared whole)."""
    code = ("import argparse, sys\n"
            "from benchmark import harness, run\n"
            "from benchmark.tests.conftest import tiny_cell\n"
            "a = argparse.Namespace(workload='naca640-cli-steps', seed=5,"
            " seconds=0.0, trace=0)\n"
            "r = run.run(a, cell=tiny_cell('naca640-cli-steps'),"
            " device='cpu')\n"
            "assert r['correct'], r\n"
            "assert 'fvens_tpu_torch' in sys.modules\n"
            "print('FORBIDDEN', harness.forbidden_modules(sys.modules))\n")
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
    assert harness.forbidden_modules(["fvens_tpu_torch.solver",
                                      "jaxlib.xla", "fvens_tpu.cases",
                                      "jax"]) == ["fvens_tpu.cases", "jax",
                                                  "jaxlib.xla"]


def test_without_a_card_the_run_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    assert run.main(["--workload", "cyl640-solve", "--seed", "1",
                     "--seconds", "1"]) == 1
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


@pytest.mark.parametrize("name", CELLS)
def test_a_step_returning_its_state_unchanged_is_caught(name, monkeypatch):
    from fvens_tpu_torch.solver.steady import SteadyBackwardEuler
    step, dstep = SteadyBackwardEuler._step, SteadyBackwardEuler._device_step

    def frozen(self, mesh, u, *a, **kw):
        out = step(self, mesh, u, *a, **kw)
        return (u,) + tuple(out[1:])

    def dfrozen(self, mesh, u, *a, **kw):
        out = dstep(self, mesh, u, *a, **kw)
        return (u,) + tuple(out[1:])
    monkeypatch.setattr(SteadyBackwardEuler, "_step", frozen)
    monkeypatch.setattr(SteadyBackwardEuler, "_device_step", dfrozen)
    cell = tiny_cell(name)
    if name == "cyl640-solve":
        # the frozen solve stops at its step limit: keep that short
        cell.config["case"]["main"]["maxiter"] = 12
    args = argparse.Namespace(workload=name, seed=11, seconds=0.0, trace=0)
    assert run.run(args, cell=cell, device="cpu")["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_produced_is_caught(name, monkeypatch):
    from fvens_tpu_torch.solver.steady import SteadyBackwardEuler
    solve = SteadyBackwardEuler.solve

    def altered(self, mesh, u0, *a, **kw):
        u, info = solve(self, mesh, u0, *a, **kw)
        return u * (1.0 + 1e-4), info
    monkeypatch.setattr(SteadyBackwardEuler, "solve", altered)
    assert _rehearse(name)["correct"] is False


def test_a_solve_stopped_short_of_the_stated_tolerance_is_caught(
        monkeypatch):
    """final_res is held to a small margin over the main solve's tol_abs
    as the configuration states it (the solver returns the output of the
    step whose input it certified): a program that stops its main solve
    at a looser tolerance reads not correct."""
    from fvens_tpu_torch.cases.casesolvers import SteadyFlowCase
    make = SteadyFlowCase._make_solver

    def loose(self, space, cfg, *a, **kw):
        if cfg.tol_abs:
            cfg = dataclasses.replace(cfg, tol_abs=cfg.tol_abs * 100)
        return make(self, space, cfg, *a, **kw)
    cell = tiny_cell("cyl640-solve")
    tol = cell.config["case"]["main"]["tol_abs"]
    limit = cell.workload["limits"]["final_res"]
    assert tol <= limit <= 2 * tol
    monkeypatch.setattr(SteadyFlowCase, "_make_solver", loose)
    line = _rehearse("cyl640-solve")
    assert line["failed"] == 0
    assert line["checks"]["final_res"]["limit"] == limit
    assert line["checks"]["final_res"]["value"] > limit
    assert line["correct"] is False


def test_the_angle_turns_by_whole_cells_of_the_mesh():
    cell = tiny_cell("cyl640-solve")
    nt = cell.config["mesh"]["nt"]
    for seed in (0, 7, 2 ** 31 + 977, 3 ** 40):
        aoa = cell.driver().Driver(cell, seed, "cpu").aoa
        k = aoa * nt / 360.0
        assert 0 <= k < nt and abs(k - round(k)) < 1e-9


def test_every_seed_poses_the_same_problem_turned():
    """The seed turns the free stream and the mesh's numbering together:
    the turned mesh is the same nodes relabelled, with the same cells,
    and two seeds' solves take the same steps and Krylov iterations to
    the same functionals (read in the wind frame)."""
    from benchmark.reference.mesh import make_mesh
    cell = tiny_cell("cyl640-solve")
    spec = cell.config["mesh"]
    nt, nr = spec["nt"], spec["nr"]
    raw0, raw = make_mesh(spec), make_mesh(dict(spec, turn=5))
    xy0 = raw0.coords.reshape(nt, nr + 1, 2)
    assert np.array_equal(raw.coords.reshape(nt, nr + 1, 2),
                          np.roll(xy0, -5, axis=0))
    assert np.array_equal(raw.cells, raw0.cells)
    assert np.array_equal(raw.bfaces, raw0.bfaces)
    solves = []
    for seed in (1, 2):
        drv = cell.driver().Driver(cell, seed, torch.device("cpu"))
        drv.setup()
        assert np.array_equal(
            drv.raw.coords, make_mesh(dict(spec, turn=drv.turn)).coords)
        drv.window(0.0)
        solves.append((drv.turn, drv.solves[0]))
    (k1, a), (k2, b) = solves
    assert k1 != k2
    for key in ("starter_steps", "main_steps", "starter_iters",
                "main_iters"):
        assert a[key] == b[key], key
    assert max(abs(x - y) for x, y in zip(a["fnl"], b["fnl"])) < 1e-12


def test_segments_check_their_first_a_seeded_and_their_last_step():
    cell = tiny_cell("naca640-cli-steps")
    cell.workload["params"]["segment_steps"] = 6
    drv = cell.driver().Driver(cell, 2 ** 31 + 5, torch.device("cpu"))
    drv.setup()
    drv.window(0.0)
    seg = drv.segments[0]
    assert seg["ok"] and len(seg["checked"]) == 3
    first, mid, last = seg["checked"]
    assert torch.equal(first["u"], drv.saved)
    assert not torch.equal(mid["u"], first["u"])
    assert not torch.equal(mid["u"], last["u"])
    numbers = drv.check()
    assert all(numbers[k] < v for k, v in cell.workload["limits"].items())


def test_solves_past_the_checked_ones_keep_nothing(monkeypatch):
    """Only the window's first CHECKED_UNITS solves keep their answer and
    first main step for the check, so the memory they hold does not grow
    with the solves that a window holds."""
    monkeypatch.setattr(harness, "CHECKED_UNITS", 1)
    cell = tiny_cell("cyl640-solve")
    drv = cell.driver().Driver(cell, 2 ** 31 + 7, torch.device("cpu"))
    drv.setup()
    drv.window(0.0)
    later = drv._solve(False)
    assert "u" in drv.solves[0] and len(drv.steps) == 1
    assert later["ok"] and "u" not in later and len(drv.rec.kept) == 1
    drv.solves.append(later)
    drv.release()
    limits = cell.workload["limits"]
    assert all(v < limits[k] for k, v in drv.check().items())


def test_segments_past_the_checked_ones_keep_nothing(monkeypatch):
    """Only the window's first CHECKED_UNITS segments keep steps for the
    check, so the recordings' device memory does not grow with the
    segments that a window holds."""
    monkeypatch.setattr(harness, "CHECKED_UNITS", 1)
    cell = tiny_cell("naca640-cli-steps")
    cell.workload["params"]["segment_steps"] = 4
    drv = cell.driver().Driver(cell, 2 ** 31 + 5, torch.device("cpu"))
    drv.setup()
    drv.window(0.0)
    later = drv._segment()
    assert len(drv.segments[0]["checked"]) == 3
    assert later["ok"] and "checked" not in later and not drv.rec.kept
    drv.segments.append(later)
    drv.release()
    limits = cell.workload["limits"]
    assert all(v < limits[k] for k, v in drv.check().items())


@pytest.mark.parametrize("name", CELLS)
def test_the_controls_fail_the_limits(name):
    """The controls at a size a test run holds: the program's f32 path and
    the reference at the precisions below the configuration's. Each
    number's sound reading lies under its limit, each control fails a
    number, and a control fails each number."""
    cell = tiny_cell(name)
    cpu = torch.device("cpu")
    sound = control.readings(cell, 3, torch.float64, False, True, cpu)
    f32 = control.readings(cell, 3, torch.float32, True, False, cpu)
    limits = cell.workload["limits"]
    controls = [f32["checked"], sound["reference_low"]]
    for reading in controls:
        assert any(reading[k] > limits[k] for k in reading), reading
    for k, limit in limits.items():
        assert sound["checked"][k] < limit, (k, sound["checked"][k])
        assert max(c.get(k, 0.0) for c in controls) > limit, k


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_command_on_a_card(name):
    """The cell as the benchmark runs it, short, on a visible card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name,
         "--seed", "4000000007", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
