"""Shared helpers of the benchmark's CPU tests: the cells at tiny sizes."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import harness

# tiny meshes at which each cell runs on the CPU in seconds
TINY = {"cyl640-solve": dict(nt=16, nr=8),
        "naca640-cli-steps": dict(nt=32, nr=16)}
TINY_PARAMS = {"naca640-cli-steps": dict(segment_steps=3)}


def tiny_cell(name: str, root: str = harness.ROOT,
              bench_dir: str = harness.BENCH_DIR) -> harness.Cell:
    cell = harness.resolve_cell(name, root, bench_dir)
    cell.config = copy.deepcopy(cell.config)
    cell.config["mesh"].update(TINY[name])
    cell.workload = copy.deepcopy(cell.workload)
    cell.workload["params"].update(TINY_PARAMS.get(name, {}))
    return cell


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
