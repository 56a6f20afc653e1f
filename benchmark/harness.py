"""What every cell of the benchmark shares: the manifest and the files it
names, the program's case objects built from a configuration file, the
recorder of the program's implicit steps, and the check that nothing of
JAX was loaded.

Everything is found by name: the cell's entry in BENCHMARK.json names its
configuration and traffic; workloads/<cell>.json holds the cell's driver,
traffic parameters and limits; configs/<config>.json the configuration;
drivers/<driver>.py the window; metrics/<metric>.py each per-layer reader.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no run may load (compared whole: the
# program's package, fvens_tpu_torch, begins with the JAX package's name)
FORBIDDEN = ("jax", "jaxlib", "flax", "fvens_tpu")
# the window's first units (solves, segments) whose answers the check
# keeps: later units keep nothing, so the device memory that the check
# holds does not grow with the units that a window holds
CHECKED_UNITS = 4


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(path: str, name: str):
    """The Python file at `path` as a module (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell, resolved: its manifest entry, workload file and
    configuration file, and the manifest's metrics that it reports."""
    name: str
    entry: dict
    workload: dict
    config: dict
    end_to_end: list
    per_layer: list
    bench_dir: str

    def driver(self):
        d = self.workload["driver"]
        return load_module(os.path.join(self.bench_dir, "drivers",
                                        f"{d}.py"), f"bench_driver_{d}")

    def metric_reader(self, name: str):
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        f"{name}.py"),
                           "bench_metric_" + name.replace(".", "_"))


def resolve_cell(name: str, root: str = ROOT,
                 bench_dir: str = BENCH_DIR) -> Cell:
    """The cell `name` of the manifest at `root`, with its files from
    `bench_dir`. Raises KeyError for a cell the manifest lacks and
    ValueError where the files disagree with the manifest."""
    man = manifest(root)
    entry = {w["name"]: w for w in man["workloads"]}[name]
    wl = load_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    for key in ("config", "traffic"):
        if wl[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} "
                             f"{wl[key]!r}, BENCHMARK.json {entry[key]!r}")
    cfg = load_json(os.path.join(bench_dir, "configs",
                                 f"{entry['config']}.json"))

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return Cell(name, entry, wl, cfg,
                [m for m in man["end_to_end"] if mine(m)],
                [m for m in man["per_layer"] if mine(m)], bench_dir)


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name is forbidden."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def sync(device) -> None:
    """Wait for the device (a no-op on the CPU)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(unit, seconds: float, trace: bool, device):
    """Units of work back to back until the first that ends after
    `seconds`. With `trace` the first unit is traced with the device's
    activity alone and the second with the host's too (at least two units
    run): the reduction has busy_s, window_s and device_ops of the first
    and idle_gaps of the second. Returns (units, window seconds, the
    reduction or None); each unit's dict gains its `wall_s`."""
    from . import tracing
    units, trace_out = [], ({} if trace else None)
    t0 = last = time.perf_counter()
    while True:
        if trace and len(units) < 2:
            part = {}
            with tracing.traced(device, part, host=bool(units)):
                units.append(unit())
            if len(units) == 1:
                trace_out.update(part)
            else:
                trace_out["idle_gaps"] = part["idle_gaps"]
        else:
            units.append(unit())
        now = time.perf_counter()
        units[-1]["wall_s"], last = now - last, now
        if now - t0 >= seconds and not (trace and len(units) < 2):
            return units, now - t0, trace_out


def counted_unit(workload: str, seed: int) -> dict:
    """The driver's counts() of one unit of `workload` at `seed`, run with
    the program's counters on in a process of its own
    (benchmark/counts.py), as the caller waits; {} where it fails."""
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.counts", "--workload", workload,
         "--seed", str(seed)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    if out.returncode:
        print(f"bench: counting run failed: {out.stderr[-1500:]}",
              file=sys.stderr)
        return {}
    return json.loads(out.stdout.strip().splitlines()[-1])


def seed_rng(seed: int) -> np.random.Generator:
    """A generator from any whole-number seed (beyond 64 bits too)."""
    return np.random.default_rng(int(seed) % (1 << 128))


# -- the program's objects from a configuration file ------------------------

def flow_config(cfg: dict, config_dir: str, aoa_deg: float):
    """The program's FlowCaseConfig of configuration file `cfg` at angle of
    attack `aoa_deg`: from its "case" sections (the program's config
    dataclasses' fields), or from its "ctrl" and "solverc" files (a
    control file and a PETSc options file, read as the program's CLI
    reads them)."""
    from fvens_tpu_torch import config as pc
    if "ctrl" in cfg:
        from fvens_tpu_torch.io_config import parse_control_file
        from fvens_tpu_torch.io_config.solverc import load_solver_options
        fc = parse_control_file(os.path.join(config_dir, cfg["ctrl"]),
                                mesh_file="generated")
        if "solverc" in cfg:
            lin, _, _ = load_solver_options(
                os.path.join(config_dir, cfg["solverc"]), base=fc.linear)
            fc = dataclasses.replace(fc, linear=lin)
    else:
        c = cfg["case"]
        fc = pc.FlowCaseConfig(
            physics=pc.PhysicsConfig(**c["physics"]),
            numerics=pc.NumericsConfig(**c["numerics"]),
            bcs=[pc.BCSpec(**b) for b in c["bcs"]],
            main=pc.PseudoTimeConfig(**c["main"]),
            init=pc.PseudoTimeConfig(**c["init"]),
            linear=pc.LinearSolverConfig(**c["linear"]),
            nl_update=pc.NonlinearUpdateConfig(**c["nl_update"]),
            wall_markers=tuple(c.get("wall_markers", ())))
    return dataclasses.replace(
        fc, physics=dataclasses.replace(fc.physics, aoa_deg=aoa_deg))


def mesh_data(raw):
    """The program's MeshData of a reference.mesh.RawMesh."""
    from fvens_tpu_torch.mesh.reader import MeshData
    nelem = raw.nelem
    four = np.full(nelem, 4, np.int32)
    return MeshData(coords=raw.coords, inpoel=raw.cells.astype(np.int32),
                    nnode=four, nfael=four.copy(),
                    bface=np.column_stack([raw.bfaces, raw.btags]).astype(
                        np.int32), nbtag=1, ndtag=0)


def plain_flow(cfg: dict, raw, aoa_deg: float, device):
    """The reference's FlowRef of configuration `cfg` on mesh `raw`."""
    import torch
    from .reference.flow import FlowRef, Gas, Geometry
    p = cfg["plain"]
    geo = Geometry(raw, {int(k): v for k, v in p["bcs"].items()}, device,
                   torch.float64)
    return FlowRef(geo, Gas(p["gamma"], p["Minf"], aoa_deg), p["flux"],
                   p["reconstruction"], p.get("weno_lambda", 0.0),
                   p["jacobian_flux"])


class StepRecorder:
    """Wraps a solver's host-loop step (SteadyBackwardEuler._step) on the
    instance, leaving its work unchanged, and keeps what the benchmark
    checks: per call the input state, the new state, cfl, rtol, omega
    cap, the residual it reported and its Krylov iterations. `take` says
    which calls to keep (None: none)."""

    def __init__(self, solver):
        self.inner = solver._step
        self.calls = 0
        self.take = None            # callable(call index) -> bool
        self.kept = []
        solver._step = self

    def __call__(self, mesh, u, cfl, rtol, omega_cap=1.0, **kw):
        out = self.inner(mesh, u, cfl, rtol, omega_cap, **kw)
        if self.take is not None and self.take(self.calls):
            rec = dict(u=u, unew=out[0], cfl=float(cfl), rtol=float(rtol),
                       omega_cap=float(omega_cap), res=float(out[1]),
                       iters=int(out[2]))
            self.kept.append(rec)
        self.calls += 1
        return out
