"""The benchmark of fvens_tpu_torch on one NVIDIA card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. It builds the cell's case from its
configuration (set-up: mesh, case, kernels built, step programs captured),
runs the cell's window for --seconds (closing at the end of the first unit
of work that ends after it), then checks the window's answers against the
plain reference and prints one JSON line: with --trace 0 the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, the first unit
of the window profiled. It exits 1 without a result where no CUDA card
(or fewer than the cell's chips) is visible or where a module of JAX or of
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# One process with few threads: the host's loop is one Python thread, and
# thread pools of the host's math libraries (read when they load) only add
# contention for the cores the card's host shares.
HOST_THREADS = "1"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def fail(msg: str) -> int:
    print(f"bench: {msg}", file=sys.stderr)
    return 1


def run(args, cell=None, device="cuda"):
    """One run: the result line's object, or 1 (printed why). `cell`: the
    resolved cell (default: args.workload's); `device` "cpu" rehearses on
    the CPU, where no device metric is read."""
    import torch
    from benchmark import harness
    cell = cell or harness.resolve_cell(args.workload)
    chips = cell.entry["chips"]
    if device == "cuda":
        if not torch.cuda.is_available():
            return fail("no CUDA device (torch.cuda.is_available() is "
                        "false); the benchmark has no CPU fallback")
        if torch.cuda.device_count() < chips:
            return fail(f"{args.workload} needs {chips} cards, "
                        f"{torch.cuda.device_count()} visible")
        print(f"bench: device {torch.cuda.get_device_name(0)}, "
              f"{torch.cuda.device_count()} visible, {power_limit()}")
        torch.cuda.reset_peak_memory_stats()
    # an indexed device: the program's counters are keyed by device index
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    drv = cell.driver().Driver(cell, args.seed, dev, trace=bool(args.trace))
    drv.setup()
    setup_s = time.perf_counter() - T_START
    win = drv.window(args.seconds)
    on_card = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    values = dict(win["e2e"], setup_s=setup_s, peak_mem_gib=peak / 2 ** 30)
    metrics, device_info = {}, dict(
        platform="gpu", kind=torch.cuda.get_device_name(0) if on_card
        else "cpu", count=chips, memory_peak_bytes=peak)
    out = {}
    if args.trace:
        obs = drv.observations()
        for m in cell.per_layer:
            v = cell.metric_reader(m["name"]).read(obs)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        tr = obs.get("trace") or {}
        device_info.update(busy_s=tr.get("busy_s", 0.0),
                           window_s=tr.get("window_s", 0.0))
        out["breakdown"] = dict(device_ops=tr.get("device_ops", []),
                                idle_gaps=tr.get("idle_gaps", []))
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = dict(value=values[m["name"]],
                                      unit=m["unit"])
    drv.release()
    if on_card:
        torch.cuda.empty_cache()
    numbers = drv.check()
    limits = cell.workload["limits"]
    checks = {k: dict(value=numbers[k], limit=limits[k]) for k in limits}
    passed = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                 for c in checks.values())
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return dict(correct=bool(passed and win["failed"] == 0),
                attempted=win["attempted"], failed=win["failed"],
                metrics=metrics, device=device_info, **out, checks=checks)


def main(argv=None) -> int:
    args = parse_args(argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = HOST_THREADS
    from benchmark import harness
    # caches of the program's builds inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(harness.ROOT, ".bench_cache", sub)
    result = run(args)
    if not isinstance(result, dict):
        return 1
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        return fail("modules of JAX or of the JAX package were loaded: "
                    + ", ".join(bad))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
