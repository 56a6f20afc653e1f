"""CUDA-graph conditional (IF) nodes for the port's captured steps, and the
compare-and-set kernel that decides them.

GraphControl is the control-flow object that solver/linear.py:
gmres_device and solver/device_stepping.py hand their guarded bodies to
while a CUDA graph is being captured; each body is captured into the body
graph of an IF node, the counterpart of the JAX package's lax.while_loop
and lax.cond inside its step program. Three forms (NodeControl):

  - `run_if_cmp(op, a, b, body)`: a node decided by the compare-and-set
    kernel (`cond_set`): a < scale * b, a > b or a == 0 on two device
    scalars, computed and set in one launch right where the node needs it;
  - `run_chain(n, op, a, b, live, body)`: the Krylov iterations of a
    cycle. Iteration j + 1's node is decided by iteration j's Givens update
    (solver/givens_kernels.py), which sets it to the new `live`; the first
    by the compare-and-set kernel. The iterations sit in groups of GROUP
    under a group node that stands for the group's first iteration, so
    that a cycle that stops early reaches the rest of its group and one
    dead node per later group, not one per later iteration;
  - `run_if(pred, body)`: the generic node, for a predicate a torch op
    computed into a one-element torch.bool: a one-thread kernel sets the
    node's condition from it.

Every handle of the first two forms is made in the graph that holds its
node, with the condition 0 at every launch of the graph
(cudaGraphCondAssignDefault): a node whose handle nothing set is dead.

The nodes and the kernel come from csrc/graph_if.cu (built with nvcc at
first use, plain C interface through ctypes). A body's work is queued on a
body stream (one per nesting depth, made before the capture) that captures
into the node's body graph. Memory the body allocates comes from the
capture's memory pool: the capture runs under torch.cuda.use_mem_pool(pool),
so that allocations on the body streams join it (see
device_stepping._Captured).

`cond_set` launches its kernel on CUDA tensors and raises if the launch
fails; on CPU tensors it takes `cond_plain`, its twin (which, for a
stand-in of a graph on the CPU, sets a Handle's `cond` where the kernel sets
the node's condition). Counts: `cond_set.launches` and
`GraphControl.launches` (the set-condition kernels of generic nodes), each
once per launch captured; with solver/device_counts enabled, each IF node
reached at replay counts one "graph_if", each generic node's set-condition
kernel one "set_if" and each compare-and-set launch one "cond_set" on the
card.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .._build import CSRC_DIR, build_cuda_library
from . import device_counts

_LIB = None                # (ctypes.CDLL, BuildInfo), built at first use
MAX_DEPTH = 6              # chunk step > restart > group > iteration > pass
GROUP = 8                  # Krylov iterations under one group node
LESS, GREATER, ZERO = 0, 1, 2   # a < scale * b, a > b, a == 0
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2}


def load_library():
    """Build (at first use) and load csrc/graph_if.cu. Returns the
    BuildInfo."""
    global _LIB
    if _LIB is None:
        lib, info = build_cuda_library(
            "graph_if", [os.path.join(CSRC_DIR, "graph_if.cu")])
        lib.fvens_if_begin.argtypes = [ctypes.c_void_p] * 3
        lib.fvens_if_handle.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_ulonglong)]
        lib.fvens_if_begin_handle.argtypes = [
            ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p]
        lib.fvens_if_end.argtypes = [ctypes.c_void_p]
        lib.fvens_cond_set.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
            + [ctypes.c_double, ctypes.c_void_p, ctypes.c_ulonglong,
               ctypes.c_int, ctypes.c_void_p])
        for fn in (lib.fvens_if_begin, lib.fvens_if_handle,
                   lib.fvens_if_begin_handle, lib.fvens_if_end,
                   lib.fvens_cond_set):
            fn.restype = ctypes.c_int
        lib.fvens_if_error_string.argtypes = [ctypes.c_int]
        lib.fvens_if_error_string.restype = ctypes.c_char_p
        _LIB = (lib, info)
    return _LIB[1]


def _check(err: int, what: str):
    if err != 0:
        msg = _LIB[0].fvens_if_error_string(err).decode()
        raise RuntimeError(f"CUDA-graph IF node: {what} failed: {msg} "
                           f"(cudaError {err})")


class Handle:
    """A conditional node's handle: on the card `value` is the CUDA handle.
    Where the kernels set the node's condition, their plain twins set `cond`
    (a torch.bool) and `set_by` (the kernel's name) instead, for a stand-in
    of a graph on the CPU."""
    __slots__ = ("value", "cond", "set_by")

    def __init__(self, value: int = 0):
        self.value = value
        self.cond = None
        self.set_by = None

    def set_plain(self, pred, kernel: str):
        self.cond = pred.reshape(()).clone()
        self.set_by = kernel


def cond_plain(op: int, a, b=None, scale: float = 1.0):
    """The compare-and-set kernel's predicate as torch ops, a 0-dim
    torch.bool: a < scale * b (scale rounded to b's dtype, one product at
    that dtype), a > b, or a == 0."""
    if op == LESS:
        return (a < torch.full((), scale, dtype=b.dtype, device=b.device)
                * b).reshape(())
    if op == GREATER:
        return (a > b).reshape(())
    return (a == 0).reshape(())


def _check_cond(op, a, b, out):
    if op not in (LESS, GREATER, ZERO):
        raise ValueError(f"cond_set's op is LESS, GREATER or ZERO, not {op}")
    if a.dtype not in _DTYPES or (a.dtype == torch.int32 and op != ZERO):
        raise TypeError(f"cond_set compares float32/float64 (int32 only "
                        f"against zero), got {a.dtype}")
    if op != ZERO and (b is None or b.dtype != a.dtype):
        raise TypeError("cond_set's a and b must share one dtype")
    scalars = (a,) if op == ZERO else (a, b)
    if out is not None:
        if out.dtype != torch.bool:
            raise TypeError("cond_set writes a torch.bool")
        scalars += (out,)
    if any(t.numel() != 1 or t.device != a.device for t in scalars):
        raise ValueError("cond_set takes one-element tensors on one device")


def cond_set(op: int, a, b=None, scale: float = 1.0, out=None,
             handle: Handle | None = None):
    """p = a < scale * b (op LESS), a > b (GREATER) or a == 0 (ZERO) on
    one-element device tensors, in one kernel launch: written to `out` (a
    one-element torch.bool) where given, and, where `handle` is given, set
    as that IF node's condition (inside a capture only). Returns the bool
    tensor holding p (a new one where neither out nor handle is given),
    else None. On CPU tensors, the plain twin."""
    _check_cond(op, a, b, out)
    if not a.is_cuda:
        if a.device.type != "cpu":
            raise ValueError(f"cond_set runs on cuda or cpu, not {a.device}")
        p = cond_plain(op, a, b, scale)
        if handle is not None:
            handle.set_plain(p, "cond_set")
        if out is not None:
            out.copy_(p.reshape(out.shape))
            return out
        return None if handle is not None else p
    if out is None and handle is None:
        out = torch.empty((), dtype=torch.bool, device=a.device)
    if _LIB is None:
        load_library()
    idx = a.get_device()
    _check(_LIB[0].fvens_cond_set(
        idx, op, _DTYPES[a.dtype], a.data_ptr(),
        None if b is None else b.data_ptr(), scale,
        None if out is None else out.data_ptr(),
        0 if handle is None else handle.value, handle is not None,
        torch._C._cuda_getCurrentRawStream(idx)), "the compare-and-set "
        "kernel's launch")
    cond_set.launches += 1
    device_counts.count("cond_set", a.device)
    return out


cond_set.launches = 0


class NodeControl:
    """The IF-node structure of a capture, on three primitives a subclass
    supplies: `handle()` (a new Handle in the graph being captured, its
    condition 0 until a kernel sets it), `node(handle, body)` (an IF node
    on handle whose body graph runs body(None)) and `run_if(pred, body)`
    (the generic node)."""
    masked = False
    group = GROUP

    def run_if_cmp(self, op, a, b, body, scale=1.0, out=None):
        """body under one IF node decided by cond_set(op, a, b, scale)
        (also written to `out` where given)."""
        handle = self.handle()
        cond_set(op, a, b, scale, out=out, handle=handle)
        self.node(handle, body)

    def run_chain(self, n, op, a, b, live, body, pred=None):
        """The Krylov chain of a cycle: body(j, next, None) for j < n, each
        under its own condition. cond_set(op, a, b) writes `live` and
        decides iteration 0; iteration j's body must hand `next` (the
        Handle of iteration j + 1's node, None at the last) to its Givens
        update, which sets it to the new live. Iterations j0 .. j0 + G - 1
        sit under one group node that stands for iteration j0, each after
        the first under a node of its own. `pred` is None inside a node."""
        G = self.group
        heads = [self.handle() for _ in range(0, n, G)]
        cond_set(op, a, b, out=live, handle=heads[0])
        for g, head in enumerate(heads):
            after = heads[g + 1] if g + 1 < len(heads) else None
            self.node(head, functools.partial(
                self._group, g * G, min(n, g * G + G), after, body))

    def _group(self, j0, j1, after, body, _):
        inner = [self.handle() for _ in range(j0 + 1, j1)]
        for i, j in enumerate(range(j0, j1)):
            nxt = inner[i] if i < len(inner) else after
            if i == 0:
                body(j, nxt, None)
            else:
                self.node(inner[i - 1], functools.partial(body, j, nxt))


class GraphControl(NodeControl):
    """Control flow for a CUDA-graph capture on `device`: each guarded body
    becomes an IF node of the graph (see the module's docstring). Make it,
    and so its body streams, before the capture begins."""

    def __init__(self, device):
        self.device = torch.device(device)
        load_library()
        self.streams = [torch.cuda.Stream(self.device)
                        for _ in range(MAX_DEPTH)]
        self.depth = 0

    def _stream(self):
        return torch.cuda.current_stream(self.device).cuda_stream

    def handle(self) -> Handle:
        value = ctypes.c_ulonglong()
        _check(_LIB[0].fvens_if_handle(self._stream(), ctypes.byref(value)),
               "making a handle")
        return Handle(value.value)

    def _body(self, begin, body):
        """body(None) captured on the next depth's body stream into the node
        that `begin(outer stream, body stream)` adds."""
        if self.depth >= MAX_DEPTH:
            raise RuntimeError(f"IF nodes nest at most {MAX_DEPTH} deep")
        inner = self.streams[self.depth]
        device_counts.count("graph_if", self.device)
        _check(begin(self._stream(), inner.cuda_stream), "begin")
        self.depth += 1
        try:
            with torch.cuda.stream(inner):
                body(None)
        finally:
            self.depth -= 1
            _check(_LIB[0].fvens_if_end(inner.cuda_stream), "end")

    def node(self, handle, body):
        self._body(lambda outer, inner: _LIB[0].fvens_if_begin_handle(
            outer, handle.value, inner), body)

    def run_if(self, pred, body):
        if pred.dtype != torch.bool or pred.numel() != 1 \
                or pred.device != self.device:
            raise ValueError("an IF node's predicate is one torch.bool on "
                             f"{self.device}")
        device_counts.count("set_if", self.device)

        def begin(outer, inner):
            err = _LIB[0].fvens_if_begin(outer, pred.data_ptr(), inner)
            if err == 0:
                GraphControl.launches += 1
            return err
        self._body(begin, body)


GraphControl.launches = 0
