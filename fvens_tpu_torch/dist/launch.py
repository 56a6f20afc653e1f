"""Start D ranks, one process each, and join them.

    results = run(fn, nranks, args)

runs fn(comm, *args) on every rank, with comm the rank's dist.comm.Comm,
and returns the ranks' return values in rank order. The processes are
started with the spawn method (torch.multiprocessing), so fn must be a
function importable by its module path, and args and results picklable.

  - device "cuda" (the default) puts rank r on cuda:r (one card per rank,
    the NCCL layout); "cuda:K" puts every rank on that one card; "cpu"
    keeps them on the host. The backend defaults to NCCL on the card and
    gloo on the host; a caller that names one gets it, never another: NCCL
    refuses two ranks on one card, and a gloo group over CUDA tensors
    stages its messages through host memory (comm.py);
  - the process group's timeout is explicit (`timeout`, seconds), and
    `join_timeout` bounds the whole run: a rank that hangs fails the run
    instead of blocking its caller;
  - if one rank fails, the others are killed and the failure is raised here
    with the rank's traceback.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch

from .comm import Comm


class RankError(RuntimeError):
    """A rank raised, died or did not finish in time."""


def _rank_device(device: str, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank)
    return dev


def _rank_main(rank, nranks, backend, device, store, timeout, threads, fn,
               args, results):
    """A rank's process: join the group, run fn, report, leave."""
    import torch.distributed as dist
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=nranks, timeout=datetime.timedelta(seconds=timeout))
        try:
            # a first collective over every rank sets up the communicator
            # (NCCL's batch_isend_irecv must not be the first)
            dist.all_reduce(torch.zeros(1, device=dev if backend == "nccl"
                                        else "cpu"))
            comm = Comm(rank=rank, size=nranks, backend=backend, device=dev)
            out = fn(comm, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run(fn, nranks: int, args: tuple = (), backend: str | None = None,
        device: str = "cuda", timeout: float = 60.0,
        join_timeout: float | None = None, threads: int = 0) -> list:
    """fn(comm, *args) on `nranks` spawned ranks; returns their results in
    rank order or raises RankError. `backend` None: NCCL where `device` is
    a card, gloo on the CPU. `threads` sets each rank's
    torch.set_num_threads (0: leave torch's default)."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if backend == "nccl":
        dev = torch.device(device)
        if dev.type != "cuda" or dev.index is not None:
            raise ValueError("NCCL takes one card per rank: device 'cuda'")
        n = torch.cuda.device_count()
        if n < nranks:
            raise ValueError(f"{nranks} NCCL ranks need {nranks} cards; "
                             f"{n} visible")
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="fvens_dist_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, nranks, backend, device, os.path.join(tmp, "store"), timeout,
        threads, fn, args, results)) for r in range(nranks)]
    deadline = (None if join_timeout is None
                else time.monotonic() + join_timeout)
    got = {}
    try:
        for p in procs:
            p.start()
        while len(got) < nranks:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RankError(f"rank {dead[0]} died (exit code "
                                    f"{procs[dead[0]].exitcode}) without a "
                                    "result")
                if deadline is not None and time.monotonic() > deadline:
                    left = sorted(set(range(nranks)) - set(got))
                    raise RankError(f"ranks {left} did not finish in "
                                    f"{join_timeout} s")
                continue
            if not ok:
                raise RankError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(nranks)]
