"""The blocked-GMRES basis row append as a hand-written CUDA kernel for Hopper.

Replaces the TPU kernel `row_set` (body `_row_set_kernel`) in the JAX
package's solver/pallas_banded.py and its caller `_basis_row_set`
(solver/linear.py), fused with the scale applied before it. The kernel
(csrc/row_set.cu) computes, in place and in one pass,

    V[j, :] = w / max(hn, tiny)

with hn a one-element tensor on the device (no host sync) and tiny 1e-300
at f64, 0 at f32. It writes only row j: the TPU kernel's 8-row panel
read-modify-write and its lane-tile gate came from the TPU's tiled HBM
layout and are not carried over, so any n and any row stride work. Its
grid is sized to the card (a few blocks per SM), it moves 16 bytes per
access, and it peels the head and tail of a row that does not start on a
16-byte boundary (csrc/row_set.cu).

`row_set` launches the kernel for CUDA tensors and raises if the launch
fails; for CPU tensors it takes `rowset_plain`, the same function in plain
PyTorch. `row_set.launches` counts kernel launches. A call is kept short,
since blocked GMRES makes one per Krylov iteration and is bound by the
host: one pass of checks (every one of them guards the kernel's memory
accesses), the current stream read as an integer
(`torch._C._cuda_getCurrentRawStream`, a tenth of the host time of
`torch.cuda.current_stream`), one ctypes call.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .._build import CSRC_DIR, build_cuda_library
from . import device_counts

TINY = 1e-300              # the clamp of the norm; rounds to 0 at f32

_LIB = None                # (ctypes.CDLL, BuildInfo), built at first use
_FNS = {}                  # dtype: the kernel's C entry point


def load_library():
    """Build (at first use) and load csrc/row_set.cu. Returns the BuildInfo
    (library path, nvcc seconds, ptxas log)."""
    global _LIB
    if _LIB is None:
        src = os.path.join(CSRC_DIR, "row_set.cu")
        lib, info = build_cuda_library("row_set", [src])
        for dtype, fn in ((torch.float32, lib.fvens_row_set_f32),
                          (torch.float64, lib.fvens_row_set_f64)):
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _FNS[dtype] = fn
        lib.fvens_row_set_error_string.argtypes = [ctypes.c_int]
        lib.fvens_row_set_error_string.restype = ctypes.c_char_p
        _LIB = (lib, info)
    return _LIB[1]


def rowset_plain(V, j: int, w, hn):
    """Plain PyTorch twin of the kernel: V[j] = w / clamp_min(hn, tiny), in
    place. Returns V."""
    V[j] = w / torch.clamp_min(hn, TINY)
    return V


def _check(V, j, w, hn):
    dtype = V.dtype
    if dtype is not torch.float32 and dtype is not torch.float64:
        raise TypeError(f"row_set takes float32/float64, got {dtype}")
    if w.dtype is not dtype or hn.dtype is not dtype:
        raise TypeError("V, w and hn must share one dtype")
    dev = V.get_device()
    if w.get_device() != dev or hn.get_device() != dev:
        raise ValueError("V, w and hn must be on one device")
    if V.dim() != 2:
        raise ValueError(f"V must be (rows, n), got {tuple(V.shape)}")
    rows, n = V.shape
    if not 0 <= j < rows:
        raise ValueError(f"row {j} outside V's {rows} rows")
    if w.shape != (n,):
        raise ValueError(f"w must be ({n},), got {tuple(w.shape)}")
    if hn.numel() != 1:
        raise ValueError(f"hn must hold one value, got {tuple(hn.shape)}")
    if (n > 1 and V.stride(1) != 1) or not w.is_contiguous():
        raise ValueError("V's rows and w must be contiguous")


def row_set(V, j: int, w, hn):
    """V[j] = w / max(hn, tiny) in place: the CUDA kernel on a CUDA tensor,
    its plain twin on a CPU tensor. Returns V."""
    _check(V, j, w, hn)
    if not V.is_cuda:
        if V.device.type == "cpu":
            return rowset_plain(V, j, w, hn)
        raise ValueError(f"row_set runs on cuda or cpu, not {V.device}")
    if _LIB is None:
        load_library()
    idx = V.get_device()
    err = _FNS[V.dtype](idx, V.data_ptr() + j * V.stride(0) * V.element_size(),
                        w.data_ptr(), hn.data_ptr(), V.shape[1], TINY,
                        torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        msg = _LIB[0].fvens_row_set_error_string(err).decode()
        raise RuntimeError(f"row_set kernel launch failed: {msg} "
                           f"(cudaError {err})")
    row_set.launches += 1
    device_counts.count("row_set", V.device)
    return V


row_set.launches = 0
