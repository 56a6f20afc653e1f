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

One device takes this path only where the mesh is fully band-covered
(banded_structure returns None otherwise). The parts of a partitioned mesh
(dist/partition.py) take it through banded_structure_parts: offsets shared
by every part, and the few slots no band covers (seam cells pointing at
halo slots) in a compact per-part "rest" list, applied after the bands as
one small gather and an ordered add (rest_apply), as in the JAX package.
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

    The rest list (a part of a partitioned mesh; empty on one device): the
    NR valid slots no band covers, in (cell, slot) order.
    rest_cell: (NR,) int64 row each uncovered block belongs to.
    rest_slot: (NR,) int64 slot of cell_nbrs it came from.
    rest_nbr:  (NR,) int64 neighbour it reads.
    rest_layers: ((entries, rows), ...): the list split so that no row
              repeats within a layer; adding layer after layer sums each
              row's blocks in list order, as the JAX package's scatter-add
              does, and the same on every run.
    """
    offsets: tuple
    slot_sel: torch.Tensor
    valid: torch.Tensor
    support: tuple
    rest_cell: torch.Tensor | None = None
    rest_slot: torch.Tensor | None = None
    rest_nbr: torch.Tensor | None = None
    rest_layers: tuple = ()

    @property
    def has_rest(self) -> bool:
        return self.rest_cell is not None and self.rest_cell.numel() > 0


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
    dev = mesh.cell_nbrs.device
    return BandedStructure(offsets=offsets,
                           slot_sel=torch.from_numpy(slot_sel).to(dev),
                           valid=torch.from_numpy(valid).to(dev),
                           support=_support(valid))


def _support(valid) -> tuple:
    """Each band's (lo, hi) cell range from its (K, NC) valid mask."""
    support = []
    for k in range(valid.shape[0]):
        cells = np.flatnonzero(valid[k])
        support.append((int(cells[0]), int(cells[-1]) + 1) if len(cells)
                       else (0, 0))
    return tuple(support)


@dataclasses.dataclass(frozen=True)
class BandedParts:
    """banded_structure_parts' result: every part's band encoding as host
    arrays leading with the part axis D, in the JAX package's layout (its
    stacked BandedStructure). The rest lists are padded to the longest
    part's NR: rest_cell == NC and rest_valid == 0 on padding."""
    offsets: tuple
    slot_sel: np.ndarray      # (D, K, NC) int32
    valid: np.ndarray         # (D, K, NC) int8
    rest_cell: np.ndarray     # (D, NR) int32
    rest_slot: np.ndarray     # (D, NR) int32
    rest_nbr: np.ndarray      # (D, NR) int32
    rest_valid: np.ndarray    # (D, NR) int8

    def part(self, p: int, device) -> BandedStructure:
        """Part p's BandedStructure on `device`, its rest list cut to its
        valid entries."""
        n = int(self.rest_valid[p].sum())
        cell = self.rest_cell[p, :n].astype(np.int64)
        # the list is in row order: entry i is the (i - first)-th of its row
        seen = np.arange(n) - np.searchsorted(cell, cell)
        layers = []
        for lay in range(int(seen.max()) + 1 if n else 0):
            ent = np.flatnonzero(seen == lay)
            layers.append(tuple(torch.from_numpy(a).to(device)
                                for a in (ent, cell[ent])))

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)) \
                .to(device)
        return BandedStructure(
            offsets=self.offsets, slot_sel=t(self.slot_sel[p]),
            valid=torch.from_numpy(self.valid[p].copy()).to(device),
            support=_support(self.valid[p]), rest_cell=t(cell),
            rest_slot=t(self.rest_slot[p, :n]),
            rest_nbr=t(self.rest_nbr[p, :n]), rest_layers=tuple(layers))


def banded_structure_parts(nb, mask, max_bands: int = 8,
                           min_cover: float = 0.5,
                           max_rest_frac: float = 0.75):
    """Band analysis of PARTITIONED neighbour tables (dist/partition.py),
    the JAX package's banded_structure_parts.

    nb:   (D, NC, S) stacked part-local cell_nbrs (own cells first, halo
          slots appended: partition_mesh's local numbering).
    mask: (D, NC, S) stacked nbr_mask > 0.

    The offsets are one tuple SHARED by every part, chosen from the global
    offset histogram; per-part coverage then differs only in the valid
    masks. Slots no band covers, dominated by seam cells pointing at halo
    slots, go to the per-part rest list. Returns BandedParts, or None when
    bands would cover less than `min_cover` of the valid slots or a part's
    rest list would exceed `max_rest_frac` of a part's mean slot count (the
    caller keeps the gather path)."""
    nb = np.asarray(nb)
    mask = np.asarray(mask) > 0
    D, NC, S = nb.shape
    off = nb - np.arange(NC, dtype=nb.dtype)[None, :, None]
    offs, counts = np.unique(off[mask], return_counts=True)
    if len(offs) == 0:
        return None
    order = np.argsort(-counts)[:max_bands]
    cover = counts[order].sum() / max(1, mask.sum())
    if cover < min_cover:
        return None
    offsets = tuple(int(offs[k]) for k in order)

    K = len(offsets)
    slot_sel = np.zeros((D, K, NC), np.int32)
    valid = np.zeros((D, K, NC), np.int8)
    covered = np.zeros_like(mask)
    for k, d in enumerate(offsets):
        hit = mask & (off == d) & ~covered            # (D, NC, S)
        # only the FIRST slot at this offset joins the band (a cell can
        # have two neighbours at the same offset through a periodic seam);
        # later duplicates stay uncovered and fall into the rest list
        first = hit & (np.cumsum(hit, axis=2) == 1)
        has = first.any(axis=2)
        slot_sel[:, k] = np.where(has, first.argmax(axis=2), 0)
        valid[:, k] = has
        covered |= first
    rest = mask & ~covered
    nrs = rest.reshape(D, -1).sum(axis=1)
    NR = int(nrs.max())
    if NR > max_rest_frac * mask.sum() / D:
        return None
    rest_cell = np.full((D, NR), NC, np.int32)        # pad -> dropped
    rest_slot = np.zeros((D, NR), np.int32)
    rest_nbr = np.zeros((D, NR), np.int32)
    rest_valid = np.zeros((D, NR), np.int8)
    for p in range(D):
        cells, slots = np.nonzero(rest[p])
        n = cells.size
        rest_cell[p, :n] = cells
        rest_slot[p, :n] = slots
        rest_nbr[p, :n] = nb[p, cells, slots]
        rest_valid[p, :n] = 1
    return BandedParts(offsets, slot_sel, valid, rest_cell, rest_slot,
                       rest_nbr, rest_valid)


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


def rest_blocks(bl: BandedStructure, N):
    """Compact (NR, V, V) blocks of the slots no band covers:
    R[r] = N[rest_cell[r], rest_slot[r]]; None without a rest list. Like
    banded_blocks, paid once per Newton step."""
    if not bl.has_rest:
        return None
    return N[bl.rest_cell, bl.rest_slot]


def rest_dn_blocks(bl: BandedStructure, Dinv, N):
    """rest_blocks of D^-1 N, formed on the rest list only."""
    R = rest_blocks(bl, N)
    if R is None:
        return None
    return torch.einsum("rij,rjl->ril", Dinv[bl.rest_cell], R)


def rest_apply(bl: BandedStructure, R, x, y, sign: float = 1.0):
    """y + sign * sum over the rest list of R_r x[rest_nbr_r] at rows
    rest_cell_r, as a new tensor; x, y (NC, V). Each row's terms are added
    one at a time in list order (rest_layers)."""
    contrib = torch.einsum("rij,rj->ri", R, x[bl.rest_nbr])
    if sign != 1.0:
        contrib = sign * contrib
    y = y.clone()
    for ent, rows in bl.rest_layers:
        y[rows] = y[rows] + contrib[ent]
    return y


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


def make_banded_matvec(D, Bt, offsets, bl=None, R=None):
    """mv(x) = D x + sum_k B_k (x shifted by d_k), as K torch.roll shifts and
    cell-batched 4x4 multiply-reduces in the transposed (V, NC) layout.
    Exactly equivalent to the slot-gather matvec up to neighbour summation
    order (absent-band blocks are zero; wrapped values only ever multiply
    zeros). D (NC, V, V); Bt (K, V, V, NC) from banded_blocks. With a rest
    list (R = rest_blocks(bl, N), a part of a partitioned mesh) its blocks
    are added after the bands."""
    Dt = D.permute(1, 2, 0)                           # (V, V, NC)
    dms = _norm_offsets(offsets, D.shape[0])

    def mv(x):
        xt = x.T                                      # (V, NC)
        yt = _block_mv(Dt, xt)
        for k, d in enumerate(dms):
            yt = yt + _block_mv(Bt[k], _shift(xt, d))
        y = yt.T
        return y if R is None else rest_apply(bl, R, x, y)
    return mv


def make_banded_bsgs(Dinv, DNbt, offsets, sweeps: int, bl=None, DNr=None):
    """Banded form of the pc='bsgs' damped block-Jacobi sweeps:
    z' = D^-1 v - (D^-1 N) z_nbr with the neighbour product as K shifts,
    in the same transposed (V, NC) layout as make_banded_matvec.
    DNbt = banded_dn_blocks; DNr = rest_dn_blocks(bl, Dinv, N) where the
    part has a rest list, subtracted after the bands in every sweep."""
    Dt = Dinv.permute(1, 2, 0)                        # (V, V, NC)
    dms = _norm_offsets(offsets, Dinv.shape[0])
    rest = (None if DNr is None
            else lambda z, acc: rest_apply(bl, DNr, z, acc, sign=-1.0))

    def pc(v):
        return bsgs_sweeps(Dt, DNbt, dms, sweeps, v, rest)
    return pc


def bsgs_sweeps(Dt, DNbt, dms, sweeps: int, v, rest=None):
    """z = D^-1 v, then `sweeps` times z <- D^-1 v - sum_k (D^-1 N)_k z_(+d_k),
    with Dt (V, V, NC), DNbt (K, V, V, NC), normalized shifts dms and
    v (NC, V); returns z (NC, V) (a transposed view). `rest(z, acc)`, on
    (NC, V) tensors, then applies the rest list of the previous iterate
    z to each sweep's sum."""
    dvt = _block_mv(Dt, v.T)                          # (V, NC)
    z = dvt
    for _ in range(sweeps):
        acc = dvt
        for k, d in enumerate(dms):
            acc = acc - _block_mv(DNbt[k], _shift(z, d))
        if rest is not None:
            acc = rest(z.T, acc.T).T
        z = acc
    return z.T
