"""The gather path's slot contraction as a hand-written CUDA kernel for
Hopper: the block matvec and the whole bsgs preconditioner apply on slot
gathers.

Both roles contract S slots of V x V blocks against rows of a vector that
an index gathers (csrc/slot_gather.cu):

    y[c] = base[c] - sum_s B[c, s] x[idx[c, s]]

with B the (NC, V, S*V) operand of linear._slot_operand. The matvec
(`SlotKernel(op, idx)`) has S = 5 slots, the cell itself first, and no
base; the bsgs apply (`SlotKernel(dn, nbrs, dinv=Dinv, sweeps=k)`) is
z = D^-1 v, then k sweeps z <- D^-1 v - (D^-1 N) z_nbr over the S = 4
neighbour slots, every phase of it issued by one C call. It replaces no
TPU kernel: the JAX package's gather path is XLA (a gather and an einsum).

On CUDA tensors a call launches the kernel or raises; it takes V = 4 (the
flow equations) and V = 1 (the scalar diffusion), float32 and float64,
the matvec at S = 5 and the apply at S = 4, which is every operator the
gather path builds (cell_nbrs has four slots). On CPU tensors a call runs
the plain twin (`slot_matvec_plain`, `slot_bsgs_plain`): the row gather,
the batched product and the subtraction, which the solver ran before on
every device. The index is copied to int32 and the apply's scratch (D^-1 v,
one z) and grid-barrier counter are allocated once per operator, so a call
allocates only its output and can be captured in a CUDA graph; the calls
of one operator must be ordered by one stream (the solver's: the current
stream), as they are.

`SlotKernel.launches` counts the C calls of both roles; each also adds
one to the device count "slot_kernel" (solver/device_counts.py) and to
the program's counter "slot_kernel" (io_config/logs.py), which a traced
run reads.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .._build import CSRC_DIR, build_cuda_library
from ..io_config import logs
from . import device_counts

DTYPES = (torch.float32, torch.float64)
# (role, V): the slot count S the kernel is built for
SLOTS = {("matvec", 4): 5, ("matvec", 1): 5, ("bsgs", 4): 4, ("bsgs", 1): 4}

_LIB = None                # (ctypes.CDLL, BuildInfo), built at first use


class SlotArgs(ctypes.Structure):
    """Mirrors `SlotArgs` in csrc/slot_gather.cu."""
    _fields_ = [("op", ctypes.c_void_p), ("idx", ctypes.c_void_p),
                ("dinv", ctypes.c_void_p), ("dv", ctypes.c_void_p),
                ("z", ctypes.c_void_p), ("counter", ctypes.c_void_p),
                ("device", ctypes.c_int), ("nc", ctypes.c_int),
                ("sweeps", ctypes.c_int)]


def _entry(role: str, V: int, dtype):
    return getattr(_LIB[0], f"fvens_slot_{role}_v{V}_"
                            f"{'f32' if dtype == torch.float32 else 'f64'}")


def load_library():
    """Build (at first use) and load csrc/slot_gather.cu. Returns the
    BuildInfo (library path, nvcc seconds, ptxas log)."""
    global _LIB
    if _LIB is None:
        lib, info = build_cuda_library(
            "slot_gather", [os.path.join(CSRC_DIR, "slot_gather.cu")])
        _LIB = (lib, info)
        for role, V in SLOTS:
            for dtype in DTYPES:
                fn = _entry(role, V, dtype)
                fn.argtypes = [ctypes.POINTER(SlotArgs), ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p]
                fn.restype = ctypes.c_int
        lib.fvens_slot_error_string.argtypes = [ctypes.c_int]
        lib.fvens_slot_error_string.restype = ctypes.c_char_p
    return _LIB[1]


def slot_matvec_plain(op, idx, x):
    """Plain PyTorch twin of the matvec role: sum_s B[c, s] x[idx[c, s]]
    per cell, as one row gather and one batched product."""
    R, V, SV = op.shape
    xg = x.index_select(0, idx.reshape(-1)).reshape(R, SV, 1)
    return torch.bmm(op, xg).reshape(R, V)


def slot_bsgs_plain(dinv, dn, idx, sweeps: int, v):
    """Plain PyTorch twin of the bsgs apply: z = D^-1 v, then `sweeps`
    times z <- D^-1 v - (D^-1 N) z_nbr."""
    dv = torch.einsum("cij,cj->ci", dinv, v)
    z = dv
    for _ in range(sweeps):
        z = dv - slot_matvec_plain(dn, idx, z)
    return z


class SlotKernel:
    """The slot contraction with its operand fixed (built once per Newton
    step): the matvec x -> sum_s B_s x[idx_s] (dinv None), or the bsgs
    apply v -> z (dinv D^-1, `sweeps` sweeps of op = D^-1 N). A call
    checks its vector and launches, or on CPU tensors runs the twin."""

    launches = 0            # C calls, both roles

    def __init__(self, op, idx, dinv=None, sweeps: int = 0):
        if op.dim() != 3 or idx.dim() != 2 or idx.shape[0] != op.shape[0]:
            raise ValueError(f"op must be (NC, V, S*V) and idx (NC, S), got "
                             f"{tuple(op.shape)} and {tuple(idx.shape)}")
        NC, V, SV = op.shape
        S = idx.shape[1]
        if SV != S * V:
            raise ValueError(f"op's rows hold {SV} values, not S*V = {S * V}")
        if dinv is not None and dinv.shape != (NC, V, V):
            raise ValueError(f"dinv must be ({NC}, {V}, {V}), got "
                             f"{tuple(dinv.shape)}")
        if sweeps < 0:
            raise ValueError(f"sweeps must be >= 0, got {sweeps}")
        self.role = "matvec" if dinv is None else "bsgs"
        self.op, self.idx, self.dinv, self.sweeps = op, idx, dinv, sweeps
        self.NC, self.V, self.S = NC, V, S
        self.dtype, self.device = op.dtype, op.device
        if self.device.type == "cpu":
            return
        if self.device.type != "cuda":
            raise ValueError(f"the slot kernel runs on cuda or cpu, not "
                             f"{self.device}")
        if self.dtype not in DTYPES:
            raise TypeError(f"the slot kernel takes float32/float64, got "
                            f"{self.dtype}")
        if SLOTS.get((self.role, V)) != S:
            raise ValueError(
                f"the slot kernel's {self.role} is built for "
                + ", ".join(f"V = {v}, S = {s}" for (r, v), s in
                            SLOTS.items() if r == self.role)
                + f"; got V = {V}, S = {S}")
        self._op = op = op.contiguous()
        if dinv is not None:
            self._dinv = dinv = dinv.contiguous()
        for t in [op] + ([dinv] if dinv is not None else []):
            if t.dtype != self.dtype or t.device != self.device:
                raise TypeError("op and dinv must share a dtype and device")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("op and dinv must be contiguous and "
                                 "16-byte aligned")
        if idx.device != self.device or idx.dtype.is_floating_point:
            raise TypeError("idx must be an integer tensor on op's device")
        if NC >= 2 ** 31 // max(V, S):
            raise ValueError(f"{NC} cells are beyond the kernel's int32 "
                             "indices")
        if _LIB is None:
            load_library()
        self._idx = idx.to(torch.int32).contiguous()
        self._fn = _entry(self.role, V, self.dtype)
        scratch = dv = z = counter = None
        if dinv is not None:
            scratch = torch.empty((2, NC, V), dtype=self.dtype,
                                  device=self.device)
            dv, z = scratch[0].data_ptr(), scratch[1].data_ptr()
            counter = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._scratch, self._counter = scratch, counter
        self._args = SlotArgs(
            op=op.data_ptr(), idx=self._idx.data_ptr(),
            dinv=dinv.data_ptr() if dinv is not None else None, dv=dv, z=z,
            counter=counter.data_ptr() if counter is not None else None,
            device=self.device.index, nc=NC, sweeps=sweeps)
        self._args_ref = ctypes.byref(self._args)

    def __call__(self, x):
        if x.shape != (self.NC, self.V):
            raise ValueError(f"the vector must be ({self.NC}, {self.V}), got "
                             f"{tuple(x.shape)}")
        if x.dtype != self.dtype or x.device != self.device:
            raise TypeError(f"the vector must be {self.dtype} on "
                            f"{self.device}, got {x.dtype} on {x.device}")
        if self.device.type == "cpu":
            if self.dinv is None:
                return slot_matvec_plain(self.op, self.idx, x)
            return slot_bsgs_plain(self.dinv, self.op, self.idx, self.sweeps,
                                   x)
        x = x.contiguous()
        out = torch.empty((self.NC, self.V), dtype=self.dtype,
                          device=self.device)
        dev = self.device.index
        err = self._fn(self._args_ref, x.data_ptr(), out.data_ptr(),
                       torch._C._cuda_getCurrentRawStream(dev))
        if err != 0:
            msg = _LIB[0].fvens_slot_error_string(err).decode()
            raise RuntimeError(f"slot kernel ({self.role}) launch failed: "
                               f"{msg} (cudaError {err})")
        SlotKernel.launches += 1
        device_counts.count("slot_kernel", self.device)
        logs.count("slot_kernel")
        return out
