"""Rooflines of the Krylov operators: the least time their work needs on
the card, over the time it takes.

The published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W):
3.35 TB/s of HBM bandwidth and 67 TFLOP/s in f64 and in f32 outside the
tensor cores. Every operator here is bound by bandwidth: the bytes count
each input read once and each output written once, from the operands'
shapes and dtypes, whatever the implementation reads again (an index
array, a band rolled twice, a sweep's intermediate state). So a kernel
that replaces another is held to the same bytes:

  - the block matvec y = D x + sum_k N_k x_nbr(k): D, the K neighbour
    blocks of every cell, x in, y out;
  - the block-Jacobi preconditioner of S sweeps z = D^-1 v - (D^-1 N) z:
    D^-1, the K blocks of D^-1 N, v in, z out (the sweeps' own state
    stays on chip in the ideal).

With K = 4 neighbour blocks of 4x4 per cell at 640x320 in f32 that is
72.1 MB, 21.5 us at 3.35 TB/s, for either operator.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = 67e12          # f64, and f32 outside the tensor cores


def block_operator_bytes(cells: int, nbr_blocks: int, V: int,
                         itemsize: int) -> int:
    """Bytes of one block matvec or block-Jacobi apply: the diagonal (or
    its inverse) and `nbr_blocks` neighbour blocks per cell, V x V each,
    one vector in and one out."""
    return cells * itemsize * (V * V * (1 + nbr_blocks) + 2 * V)


def block_operator_flops(cells: int, nbr_blocks: int, V: int,
                         sweeps: int = 0) -> int:
    """Floating-point operations of the matvec (sweeps = 0) or of a
    block-Jacobi apply of `sweeps` sweeps."""
    mv = 2 * cells * V * V
    if sweeps == 0:
        return mv * (1 + nbr_blocks)
    return mv + sweeps * (2 * cells * V * V * nbr_blocks + cells * V)


def event_seconds(fn, x, launches: int = 200, rounds: int = 3) -> float:
    """Device seconds per call of fn(x): `launches` calls back to back
    between CUDA events, after a warm-up; the least of `rounds`."""
    for _ in range(5):
        fn(x)
    torch.cuda.synchronize(x.device)
    best = float("inf")
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn(x)
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) * 1e-3 / launches)
    return best


def share(nbytes: int, flops: int, seconds: float) -> float:
    """Percent of the roofline: max(bytes / bandwidth, flops / peak) over
    the measured seconds."""
    floor = max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S)
    return 100.0 * floor / seconds


def operator_share(op: dict) -> float:
    """Roofline share of an operator record {fn, x, cells, nbr_blocks, V,
    sweeps, dtype} (a driver's `operators`), timed now."""
    itemsize = torch.empty((), dtype=op["dtype"]).element_size()
    return share(block_operator_bytes(op["cells"], op["nbr_blocks"],
                                      op["V"], itemsize),
                 block_operator_flops(op["cells"], op["nbr_blocks"],
                                      op["V"], op["sweeps"]),
                 event_seconds(op["fn"], op["x"]))
