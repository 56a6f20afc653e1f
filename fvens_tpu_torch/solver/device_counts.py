"""Launch counts kept on the card, for the paths that replay CUDA graphs.

A kernel wrapper's `launches` attribute counts the launches made from the
host. A launch captured into a CUDA graph is made once, at capture, and
then runs at every replay (and, inside a conditional node, only where the
node's condition holds), so on the graph paths (solver/device_stepping.py)
the host counts say nothing about what ran. With `enable(device)` each
wrapper also adds one to its slot of a counter tensor on the card right
after each launch; captured, the add runs exactly when the launch does.
`read()` returns the counts (one device-to-host copy), `disable()` stops
counting. Counting is off by default: each count is one more small kernel.
A graph captured while counting keeps its adds and so goes on counting
into the same tensor, which is therefore never freed; enabling again
reuses (and zeroes) it.
"""

from __future__ import annotations

import contextlib

import torch

# "bsgs_apply" counts the cooperative bsgs kernel's launches,
# "bsgs_cluster" the cluster kernel's (banded_kernels.BsgsApply.design);
# "graph_if" the IF nodes reached (live or dead), "set_if" the
# set-condition kernels of generic nodes, "cond_set" the compare-and-set
# kernel's launches (solver/graph_if.py); "slot_kernel" the gather path's
# slot contraction's C calls (solver/slot_kernels.py: a matvec, or a whole
# bsgs apply)
NAMES = ("banded_apply", "bsgs_apply", "row_set", "givens_column",
         "graph_if", "set_if", "cond_set", "bsgs_cluster", "slot_kernel")

_COUNTS = {}               # device index: int64 tensor (len(NAMES),)
_KEPT = {}                 # every counter made, counting or not


def enable(device) -> None:
    """Count launches on `device` from now on, from zero."""
    device = torch.device(device)
    t = _KEPT.get(device.index)
    if t is None:
        t = _KEPT[device.index] = torch.zeros(len(NAMES), dtype=torch.int64,
                                              device=device)
    t.zero_()
    _COUNTS[device.index] = t


def disable() -> None:
    _COUNTS.clear()


def count(name: str, device) -> None:
    """One launch of `name` on `device` (a CUDA device): a no-op unless
    counting is enabled there."""
    t = _COUNTS.get(device.index)
    if t is not None:
        t.narrow(0, NAMES.index(name), 1).add_(1)


@contextlib.contextmanager
def paused():
    """No counting inside (a program's warm-up: set-up, not the path's
    work); counting resumes where it was on."""
    saved = dict(_COUNTS)
    _COUNTS.clear()
    try:
        yield
    finally:
        _COUNTS.update(saved)


def zero() -> None:
    for t in _COUNTS.values():
        t.zero_()


def read(device) -> dict:
    """{kernel name: launches counted on `device`}."""
    t = _KEPT[torch.device(device).index]
    return dict(zip(NAMES, (int(x) for x in t.tolist())))
