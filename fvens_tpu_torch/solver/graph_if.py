"""CUDA-graph conditional (IF) nodes for the port's captured steps.

GraphControl is the control-flow object that solver/linear.py:
gmres_device and solver/device_stepping.py hand their guarded bodies to
while a CUDA graph is being captured: `run_if(pred, body)` captures
`body(None)` into the body graph of an IF node that runs, at every replay,
only where the one-element torch.bool tensor `pred` holds at that point of
the graph. This is the counterpart of the JAX package's lax.while_loop and
lax.cond inside its step program.

The nodes come from csrc/graph_if.cu (built with nvcc at first use, plain C
interface through ctypes): fvens_if_begin adds to the graph the current
stream is capturing a one-thread kernel that sets the node's condition from
`pred`, then the IF node, and starts capturing a body stream into the
node's body graph; the body's work is queued on that stream (one stream
per nesting depth, made before the capture); fvens_if_end ends the body's
capture. Memory the body allocates comes from the capture's memory pool:
the capture runs under torch.cuda.use_mem_pool(pool), so that allocations
on the body streams join it (see device_stepping._Captured).

`GraphControl.launches` counts the set-condition kernels captured (one per
IF node, at capture); with solver/device_counts enabled, each IF node
reached at replay also counts one "graph_if" launch on the card.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .._build import CSRC_DIR, build_cuda_library
from . import device_counts

_LIB = None                # (ctypes.CDLL, BuildInfo), built at first use
MAX_DEPTH = 6              # nesting: chunk step > cycle > iteration > pass


def load_library():
    """Build (at first use) and load csrc/graph_if.cu. Returns the
    BuildInfo."""
    global _LIB
    if _LIB is None:
        lib, info = build_cuda_library(
            "graph_if", [os.path.join(CSRC_DIR, "graph_if.cu")])
        lib.fvens_if_begin.argtypes = [ctypes.c_void_p] * 3
        lib.fvens_if_begin.restype = ctypes.c_int
        lib.fvens_if_end.argtypes = [ctypes.c_void_p]
        lib.fvens_if_end.restype = ctypes.c_int
        lib.fvens_if_error_string.argtypes = [ctypes.c_int]
        lib.fvens_if_error_string.restype = ctypes.c_char_p
        _LIB = (lib, info)
    return _LIB[1]


def _check(err: int, what: str):
    if err != 0:
        msg = _LIB[0].fvens_if_error_string(err).decode()
        raise RuntimeError(f"CUDA-graph IF node: {what} failed: {msg} "
                           f"(cudaError {err})")


class GraphControl:
    """Control flow for a CUDA-graph capture on `device`: each guarded body
    becomes an IF node of the graph (see the module's docstring). Make it,
    and so its body streams, before the capture begins."""
    masked = False

    def __init__(self, device):
        self.device = torch.device(device)
        load_library()
        self.streams = [torch.cuda.Stream(self.device)
                        for _ in range(MAX_DEPTH)]
        self.depth = 0

    def run_if(self, pred, body):
        if pred.dtype != torch.bool or pred.numel() != 1 \
                or pred.device != self.device:
            raise ValueError("an IF node's predicate is one torch.bool on "
                             f"{self.device}")
        if self.depth >= MAX_DEPTH:
            raise RuntimeError(f"IF nodes nest at most {MAX_DEPTH} deep")
        lib = _LIB[0]
        outer = torch.cuda.current_stream(self.device)
        inner = self.streams[self.depth]
        device_counts.count("graph_if", self.device)
        _check(lib.fvens_if_begin(outer.cuda_stream, pred.data_ptr(),
                                  inner.cuda_stream), "begin")
        GraphControl.launches += 1
        self.depth += 1
        try:
            with torch.cuda.stream(inner):
                body(None)
        finally:
            self.depth -= 1
            _check(lib.fvens_if_end(inner.cuda_stream), "end")


GraphControl.launches = 0
