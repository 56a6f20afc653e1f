"""The Givens/Hessenberg column update of FGMRES as a hand-written CUDA
kernel for Hopper.

Replaces no Pallas kernel of the JAX package: it is the device form of the
rotation bookkeeping inside the JAX package's FGMRES while body (the `rot`
fori_loop and the rotation update, fvens_tpu/solver/linear.py:400-420 and
480-495), which runs there inside the one XLA program of a step. The
port's host-controlled gmres does the same arithmetic on the host in NumPy
(solver/linear.py:_hessenberg_column); the device-controlled cycle
(solver/linear.py:gmres_device) launches this kernel once per Krylov
iteration instead, so that a captured step graph reads nothing back.

`givens_column(h, hn, j, H, cs, sn, g, res, tol, live, iters, next_cond)`
updates, in place and only where `live` is true, the Krylov state of
iteration j of a cycle of m = cs.shape[0]:

  - applies the j stored rotations (cs, sn) to the new column (h[0..j],
    hn), forms rotation j and stores it, updates g;
  - res = |g[j+1]|, live = live and res > tol and j + 1 < m, iters += 1;
  - H[:, j] = the rotated column (zeros below row j + 1);
  - inside a captured graph, sets the condition of `next_cond` (a
    graph_if.Handle: the IF node of the next Krylov iteration, or of the
    next group of them) to the new live; that is how the captured cycle's
    iterations chain (graph_if.NodeControl.run_chain). Off a capture it is
    None.

h, hn, H, cs, sn, g, res and tol share the Krylov dtype (f32 or f64), live
is a one-element torch.bool tensor and iters a one-element int32 tensor,
all on one device. The kernel (csrc/givens_column.cu) rounds every
operation separately (no FMA contraction, IEEE square root and division),
as `givens_plain`, the plain PyTorch twin, does: the two agree bit for
bit. With the host's NumPy arithmetic they agree bit for bit but where
NumPy's scalar ** 2 (pow) rounds one of the two squares off the product
that the kernel, the twin and the JAX package's XLA form (about one square
in 1,500): there the results differ in the last bits.

`givens_column` launches the kernel (one warp) for CUDA tensors and raises
if the launch fails; for CPU tensors it takes `givens_plain`, which sets
next_cond's `cond` where the kernel sets the node's condition.
`givens_column.launches` counts kernel launches (a launch inside a CUDA
graph is counted once, when it is captured).
"""

from __future__ import annotations

import ctypes
import os

import torch

from .._build import CSRC_DIR, build_cuda_library
from . import device_counts

TINY = 1e-300              # the clamp of the denominator; rounds to 0 at f32
MAX_RESTART = 512          # the kernel's limit on the restart

_LIB = None                # (ctypes.CDLL, BuildInfo), built at first use
_FNS = {}                  # dtype: the kernel's C entry point


def load_library():
    """Build (at first use) and load csrc/givens_column.cu. Returns the
    BuildInfo (library path, nvcc seconds, ptxas log)."""
    global _LIB
    if _LIB is None:
        src = os.path.join(CSRC_DIR, "givens_column.cu")
        lib, info = build_cuda_library("givens_column", [src])
        for dtype, fn in ((torch.float32, lib.fvens_givens_column_f32),
                          (torch.float64, lib.fvens_givens_column_f64)):
            fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_int]
                           + [ctypes.c_void_p] * 8
                           + [ctypes.c_double, ctypes.c_ulonglong,
                              ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _FNS[dtype] = fn
        lib.fvens_givens_error_string.argtypes = [ctypes.c_int]
        lib.fvens_givens_error_string.restype = ctypes.c_char_p
        _LIB = (lib, info)
    return _LIB[1]


def givens_plain(h, hn, j: int, H, cs, sn, g, res, tol, live, iters,
                 next_cond=None):
    """Plain PyTorch twin of the kernel, the same recurrence one operation
    at a time, every write selected by `live` (a dead call changes
    nothing; where live is false the kernel does not run, so it sets no
    condition)."""
    m = cs.shape[0]
    alive = live.reshape(()).clone()
    col = list(torch.cat([h[:j + 1], hn.reshape(1)]).unbind())
    for i in range(j):
        c, s, a, b = cs[i], sn[i], col[i], col[i + 1]
        col[i] = c * a + s * b
        col[i + 1] = -s * a + c * b
    a, b = col[j], col[j + 1]
    denom = torch.sqrt(a * a + b * b)
    d = torch.where(denom < TINY, torch.full_like(denom, TINY), denom)
    c, s = a / d, b / d
    col[j], col[j + 1] = denom, torch.zeros_like(denom)
    gj = g[j]
    g1 = -s * gj
    newcol = torch.zeros(m + 1, dtype=H.dtype, device=H.device)
    newcol[:j + 2] = torch.stack(col)
    r = torch.abs(g1)

    def put(t, idx, v):
        t[idx] = torch.where(alive, v, t[idx])
    put(cs, j, c)
    put(sn, j, s)
    put(g, j + 1, g1)
    put(g, j, c * gj)
    put(H, (slice(None), j), newcol)
    res.copy_(torch.where(alive, r, res.reshape(())).reshape(res.shape))
    new_live = alive & (r > tol.reshape(())) & (j + 1 < m)
    live.copy_(new_live.reshape(live.shape))
    iters.add_(alive.to(iters.dtype).reshape(iters.shape))
    if next_cond is not None and bool(alive):
        next_cond.set_plain(new_live, "givens_column")


def _check(h, hn, j, H, cs, sn, g, res, tol, live, iters):
    dtype = H.dtype
    if dtype is not torch.float32 and dtype is not torch.float64:
        raise TypeError(f"givens_column takes float32/float64, got {dtype}")
    floats = (h, hn, cs, sn, g, res, tol)
    if any(t.dtype is not dtype for t in floats):
        raise TypeError("h, hn, H, cs, sn, g, res and tol must share one "
                        "dtype")
    if live.dtype is not torch.bool or iters.dtype is not torch.int32:
        raise TypeError("live must be torch.bool and iters torch.int32")
    tensors = (h, hn, H, cs, sn, g, res, tol, live, iters)
    if any(t.device != H.device for t in tensors):
        raise ValueError("givens_column's tensors must be on one device")
    m = cs.shape[0]
    if not 1 <= m <= MAX_RESTART:
        raise ValueError(f"a cycle of 1 to {MAX_RESTART} iterations, got {m}")
    if not 0 <= j < m:
        raise ValueError(f"iteration {j} outside a cycle of {m}")
    if (tuple(H.shape) != (m + 1, m) or sn.shape != cs.shape
            or tuple(g.shape) != (m + 1,) or h.dim() != 1
            or h.shape[0] < j + 1):
        raise ValueError(f"need H ({m + 1}, {m}), cs and sn ({m},), g "
                         f"({m + 1},) and h of at least {j + 1}, got "
                         f"{tuple(H.shape)}, {tuple(cs.shape)}, "
                         f"{tuple(sn.shape)}, {tuple(g.shape)}, "
                         f"{tuple(h.shape)}")
    if any(t.numel() != 1 for t in (hn, res, tol, live, iters)):
        raise ValueError("hn, res, tol, live and iters hold one value each")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("givens_column's tensors must be contiguous")


def givens_column(h, hn, j: int, H, cs, sn, g, res, tol, live, iters,
                  next_cond=None):
    """Iteration j's rotation update of the Krylov state, in place (and the
    condition of the next node, `next_cond`, inside a capture): the CUDA
    kernel on CUDA tensors, its plain twin on CPU tensors."""
    _check(h, hn, j, H, cs, sn, g, res, tol, live, iters)
    if not H.is_cuda:
        if H.device.type == "cpu":
            return givens_plain(h, hn, j, H, cs, sn, g, res, tol, live,
                                iters, next_cond)
        raise ValueError(f"givens_column runs on cuda or cpu, not "
                         f"{H.device}")
    if _LIB is None:
        load_library()
    idx = H.get_device()
    err = _FNS[H.dtype](idx, h.data_ptr(), hn.data_ptr(), j, cs.shape[0],
                        H.data_ptr(), cs.data_ptr(), sn.data_ptr(),
                        g.data_ptr(), res.data_ptr(), tol.data_ptr(),
                        live.data_ptr(), iters.data_ptr(), TINY,
                        0 if next_cond is None else next_cond.value,
                        next_cond is not None,
                        torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        msg = _LIB[0].fvens_givens_error_string(err).decode()
        raise RuntimeError(f"givens_column kernel launch failed: {msg} "
                           f"(cudaError {err})")
    givens_column.launches += 1
    device_counts.count("givens_column", H.device)


givens_column.launches = 0
