"""Banded (shifted-slice) neighbour encoding for the block linear stack.

On GENERATED structured meshes (the O-mesh families of the benchmarks) the
neighbour index of every valid slot is `cell + d` for a handful of fixed
offsets d — e.g. a ni x nj O-mesh in row-major order has exactly SIX:
{-nj, -1, +1, +nj} in the interior plus the two circumferential seam
offsets +-(n_cells - nj). When that holds, the per-iteration slot gather of
the block matvec and of the block-Jacobi sweeps becomes K contiguous shifts
of the state vector, each multiplied by a (V, V) block per cell.

This module holds the host-side band analysis and the PLAIN PyTorch
operators over torch.roll: the twins that solver/banded_kernels.py's CUDA
kernel is held against, and the path taken on the CPU and with
LinearSolverConfig(pallas=False).

Only fully band-covered meshes take this path (banded_structure returns
None otherwise). The partial encoding with an uncovered "rest" list, which
the JAX package uses on partitioned meshes, belongs to the distributed path
and is still to be ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BandedStructure:
    """Static band encoding of a CompiledMesh's neighbour slots.

    offsets:  K Python ints: band k holds neighbours at cell + d_k.
    slot_sel: (K, NC) int64 — which slot of cell_nbrs holds that neighbour
              (0 where the band is absent; see valid).
    valid:    (K, NC) int8 — 1 where cell c really has a neighbour at
              offset d_k (selected blocks are multiplied by this).
    support:  K (lo, hi) Python int pairs: band k's valid cells all lie in
              [lo, hi), so its blocks are exactly zero outside (on the
              O-meshes the seam bands hold one ring of cells).
    """
    offsets: tuple
    slot_sel: torch.Tensor
    valid: torch.Tensor
    support: tuple


def banded_structure(mesh, max_bands: int = 8):
    """Host-side band analysis of mesh.cell_nbrs (NumPy).

    Returns a BandedStructure covering EVERY valid neighbour slot with at
    most `max_bands` offsets, or None when the mesh is not band-coverable.
    Requiring 100% coverage keeps the banded operators exactly equivalent
    (up to summation order) to the slot-gather operators. Two bands may
    share a normalized shift (the seam bands of an O-mesh): they stay
    separate bands with their own blocks.
    """
    nb = mesh.cell_nbrs.cpu().numpy()
    mask = mesh.nbr_mask.cpu().numpy() > 0        # the Jacobian's zero rule
    NC = nb.shape[0]
    off = nb - np.arange(NC, dtype=nb.dtype)[:, None]
    offs, counts = np.unique(off[mask], return_counts=True)
    if len(offs) > max_bands:
        return None
    order = np.argsort(-counts)
    offsets = tuple(int(offs[k]) for k in order)
    slot_sel = np.zeros((len(offsets), NC), dtype=np.int64)
    valid = np.zeros((len(offsets), NC), dtype=np.int8)
    for k, d in enumerate(offsets):
        hit = mask & (off == d)                   # (NC, S)
        has = hit.any(axis=1)
        slot_sel[k] = np.where(has, hit.argmax(axis=1), 0)
        valid[k] = has
    # every valid slot must land in exactly one band
    if int(valid.sum()) != int(mask.sum()):
        return None
    support = []
    for k in range(len(offsets)):
        cells = np.flatnonzero(valid[k])
        support.append((int(cells[0]), int(cells[-1]) + 1) if len(cells)
                       else (0, 0))
    dev = mesh.cell_nbrs.device
    return BandedStructure(offsets=offsets,
                           slot_sel=torch.from_numpy(slot_sel).to(dev),
                           valid=torch.from_numpy(valid).to(dev),
                           support=tuple(support))


def banded_blocks(bl: BandedStructure, N):
    """Reorder per-slot neighbour blocks (NC, S, V, V) into per-band blocks
    (K, V, V, NC), contiguous: B[k, :, :, c] = N[c, slot_sel[k, c]] (zero
    where the band is absent). Paid once per Newton step; it replaces a
    gather PER KRYLOV ITERATION. Cells are the minor axis, so a kernel
    reading one block entry for consecutive cells reads consecutive
    addresses."""
    S = N.shape[1]
    Nt = N.permute(1, 2, 3, 0)                        # (S, V, V, NC)
    vm = bl.valid.to(N.dtype)                         # (K, NC)
    out = None
    for s in range(S):
        m = torch.where(bl.slot_sel == s, vm, 0)      # (K, NC)
        term = m[:, None, None, :] * Nt[s][None]      # (K, V, V, NC)
        out = term if out is None else out + term
    return out.contiguous()


def _block_mv(Bt, xt):
    """y[i,c] = sum_j Bt[i,j,c] x[j,c] as a broadcast multiply-reduce."""
    return (Bt * xt[None, :, :]).sum(dim=1)


def banded_dn_blocks(bl: BandedStructure, Dinv, N):
    """Band-reordered (K, V, V, NC) blocks of D^-1 N for the banded bsgs
    sweeps, WITHOUT materializing the (NC, S, V, V) product: select bands
    from N first (K <= S), then multiply by D^-1 in the cell-minor layout."""
    Bt = banded_blocks(bl, N)                         # (K, V, V, NC)
    Dt = Dinv.permute(1, 2, 0)                        # (V, V, NC)
    # out[k,i,l,c] = sum_j Dt[i,j,c] Bt[k,j,l,c]
    return (Dt[None, :, :, None, :] * Bt[:, None, :, :, :]).sum(dim=2) \
        .contiguous()


def _norm_offsets(offsets, NC):
    """Normalize roll offsets into (-NC/2, NC/2]: a shift is modular, so the
    O-mesh seam offsets +-(NC - nj) are really -+nj. Duplicates are kept."""
    out = []
    for d in offsets:
        dm = d % NC
        if dm > NC // 2:
            dm -= NC
        out.append(dm)
    return tuple(out)


def _shift(xt, d):
    """xt (V, NC) read at column (c + d) mod NC."""
    return torch.roll(xt, -d, dims=1) if d else xt


def make_banded_matvec(D, Bt, offsets):
    """mv(x) = D x + sum_k B_k (x shifted by d_k), as K torch.roll shifts and
    cell-batched 4x4 multiply-reduces in the transposed (V, NC) layout.
    Exactly equivalent to the slot-gather matvec up to neighbour summation
    order (absent-band blocks are zero; wrapped values only ever multiply
    zeros). D (NC, V, V); Bt (K, V, V, NC) from banded_blocks."""
    Dt = D.permute(1, 2, 0)                           # (V, V, NC)
    dms = _norm_offsets(offsets, D.shape[0])

    def mv(x):
        xt = x.T                                      # (V, NC)
        yt = _block_mv(Dt, xt)
        for k, d in enumerate(dms):
            yt = yt + _block_mv(Bt[k], _shift(xt, d))
        return yt.T
    return mv


def make_banded_bsgs(Dinv, DNbt, offsets, sweeps: int):
    """Banded form of the pc='bsgs' damped block-Jacobi sweeps:
    z' = D^-1 v - (D^-1 N) z_nbr with the neighbour product as K shifts,
    in the same transposed (V, NC) layout as make_banded_matvec.
    DNbt = banded_dn_blocks."""
    Dt = Dinv.permute(1, 2, 0)                        # (V, V, NC)
    dms = _norm_offsets(offsets, Dinv.shape[0])

    def pc(v):
        return bsgs_sweeps(Dt, DNbt, dms, sweeps, v)
    return pc


def bsgs_sweeps(Dt, DNbt, dms, sweeps: int, v):
    """z = D^-1 v, then `sweeps` times z <- D^-1 v - sum_k (D^-1 N)_k z_(+d_k),
    with Dt (V, V, NC), DNbt (K, V, V, NC), normalized shifts dms and
    v (NC, V); returns z (NC, V) (a transposed view)."""
    dvt = _block_mv(Dt, v.T)                          # (V, NC)
    z = dvt
    for _ in range(sweeps):
        acc = dvt
        for k, d in enumerate(dms):
            acc = acc - _block_mv(DNbt[k], _shift(z, d))
        z = acc
    return z.T
