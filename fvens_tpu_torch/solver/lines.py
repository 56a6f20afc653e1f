"""Line-implicit smoothing structures, the JAX package's solver/lines.py in
PyTorch.

Boundary-layer meshes couple cells strongly across the wall-normal
direction; point-block smoothers converge slowly there. The reference
detects such "lines" for ordering only (FVENS src/mesh/meshordering.cpp:
33-66); here they drive a block-tridiagonal solve along each line inside
the preconditioner (pc="bline"), batched over all lines: block_thomas is
a loop over the (at most 32) positions of a line, each step a few batched
(NL, V, V) products, so on the card it is bound by its launches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mesh.ordering import find_lines_core
from .linear import block_jacobi_inverse


@dataclasses.dataclass(frozen=True)
class LineStructure:
    """Padded line arrays. NL lines of up to Lmax cells; every real cell
    appears in exactly one line (isolated cells form length-1 lines)."""
    line_cells: torch.Tensor      # (NL, Lmax) int64 cell ids, pad = NC-1
    line_mask: torch.Tensor       # (NL, Lmax) 1.0 for real entries
    dn_slot: torch.Tensor         # (NL, Lmax) int64 slot of cell i -> i-1
    up_slot: torch.Tensor         # (NL, Lmax) int64 slot of cell i -> i+1
    dn_valid: torch.Tensor        # (NL, Lmax) 1.0 where dn_slot is a link
    up_valid: torch.Tensor        # (NL, Lmax) 1.0 where up_slot is a link
    line_slot_mask: torch.Tensor  # (NC, 4) 1.0 where the slot couples
    #                               along a line
    cell_line_pos: torch.Tensor   # (NC, 2) int64 (line, pos) of each cell
    n_lines: int
    Lmax: int


def build_lines(mesh_np_nbrs, mesh_np_mask, rc, nfael_active,
                NC: int, anisotropy_threshold: float = 2.0,
                max_len: int = 0, device="cpu") -> LineStructure:
    """Greedy strong-coupling line detection on the compiled incidence
    (host, NumPy); the arrays become tensors on `device`.

    mesh_np_nbrs:  (NC,4) neighbour cell ids
    mesh_np_mask:  (NC,4) 1 where the neighbour is a real cell
    rc:            (NC,2) cell centres
    nfael_active:  (n_cells,) number of active slots of the real cells
    Coupling weight between adjacent cells = 1/distance(centres); a line is
    grown along the strongest coupling while the local max/min weight ratio
    exceeds `anisotropy_threshold` (meshordering details_lineordering.hpp).
    """
    n_real = int(nfael_active.shape[0])
    nbrs = mesh_np_nbrs
    mask = mesh_np_mask

    # seed from boundary cells first (the reference's behaviour), then from
    # every remaining cell so interior anisotropic regions form lines too
    esuel = np.where(mask[:n_real] > 0, nbrs[:n_real], -1)
    nfael = np.full(n_real, esuel.shape[1], dtype=np.int64)
    bcells = np.flatnonzero((mask[:n_real] == 0).any(axis=1))
    seeds = np.concatenate([bcells, np.arange(n_real)])
    found, in_line = find_lines_core(esuel, nfael, rc[:n_real], seeds,
                                     anisotropy_threshold)
    if max_len:
        clipped = []
        for line in found:
            for s in range(0, len(line), max_len):
                clipped.append(line[s:s + max_len])
        found = clipped

    lines: list[list[int]] = list(found)
    # every remaining real cell becomes a singleton line (the smoother
    # needs each cell in exactly one line; singletons degenerate to
    # block-Jacobi there)
    for c in range(n_real):
        if in_line[c] < 0:
            lines.append([c])

    NL = len(lines)
    Lmax = max(len(l) for l in lines)
    line_cells = np.full((NL, Lmax), NC - 1, np.int64)
    line_mask = np.zeros((NL, Lmax))
    dn_slot = np.zeros((NL, Lmax), np.int64)
    up_slot = np.zeros((NL, Lmax), np.int64)
    dn_valid = np.zeros((NL, Lmax))
    up_valid = np.zeros((NL, Lmax))
    line_slot_mask = np.zeros((NC, 4))
    cell_line_pos = np.zeros((NC, 2), np.int64)

    def slot_between(c, nb):
        for k in range(4):
            if mask[c, k] > 0 and int(nbrs[c, k]) == nb:
                return k
        return -1

    for li, line in enumerate(lines):
        cells = list(line)
        for i, c in enumerate(cells):
            line_cells[li, i] = c
            line_mask[li, i] = 1.0
            cell_line_pos[c] = (li, i)
            if i > 0:
                k = slot_between(c, cells[i - 1])
                if k >= 0:
                    dn_slot[li, i] = k
                    dn_valid[li, i] = 1.0
                    line_slot_mask[c, k] = 1.0
            if i + 1 < len(cells):
                k = slot_between(c, cells[i + 1])
                if k >= 0:
                    up_slot[li, i] = k
                    up_valid[li, i] = 1.0
                    line_slot_mask[c, k] = 1.0

    def t(a):
        return torch.as_tensor(a, device=device)
    return LineStructure(
        line_cells=t(line_cells), line_mask=t(line_mask),
        dn_slot=t(dn_slot), up_slot=t(up_slot), dn_valid=t(dn_valid),
        up_valid=t(up_valid), line_slot_mask=t(line_slot_mask),
        cell_line_pos=t(cell_line_pos), n_lines=NL, Lmax=Lmax)


def lines_from_mesh(mesh, anisotropy_threshold: float = 2.0,
                    max_len: int = 32) -> LineStructure:
    """LineStructure of a CompiledMesh (host pass), on the mesh's device.

    Lines are clipped to `max_len` for the smoother: clipped segments stay
    exact block-tridiagonal solves (the cut couplings are lagged like any
    off-line block), and a bounded length bounds block_thomas's loop."""
    nbrs = mesh.cell_nbrs.cpu().numpy()
    mask = mesh.nbr_mask.cpu().numpy()
    rc = mesh.rc.cpu().numpy()
    nf = np.abs(mesh.cell_fsign.cpu().numpy()).sum(axis=1)[:mesh.n_cells]
    return build_lines(nbrs, mask, rc, nf, mesh.NC,
                       anisotropy_threshold=anisotropy_threshold,
                       max_len=max_len, device=mesh.cell_nbrs.device)


def thomas_factor(a, b, c):
    """The forward elimination's d-independent part of block_thomas:
    w_i = (b_i - a_i q_{i-1})^-1 and q_i = w_i c_i, position by position.
    a, b, c: (NL, L, V, V). Returns (w, q), lists of L (NL, V, V)."""
    NL, L, V, _ = b.shape
    q_prev = torch.zeros((NL, V, V), dtype=b.dtype, device=b.device)
    ws, qs = [], []
    for i in range(L):
        m = b[:, i] - torch.bmm(a[:, i], q_prev)
        w = block_jacobi_inverse(m)
        q_prev = torch.bmm(w, c[:, i])
        ws.append(w)
        qs.append(q_prev)
    return ws, qs


def thomas_solve(a, factor, d):
    """x of the block-tridiagonal system factored by thomas_factor, for
    right-hand sides d (NL, L, V): y_i = w_i (d_i - a_i y_{i-1}), then
    x_i = y_i - q_i x_{i+1}. One loop over L forward and one back, each
    step a few batched (NL, V, V) products."""
    ws, qs = factor
    NL, L, V = d.shape
    y = torch.zeros((NL, V), dtype=d.dtype, device=d.device)
    ys = []
    for i in range(L):
        r = d[:, i] - torch.bmm(a[:, i], y[..., None])[..., 0]
        y = torch.bmm(ws[i], r[..., None])[..., 0]
        ys.append(y)
    x = torch.zeros_like(y)
    xs = [None] * L
    for i in range(L - 1, -1, -1):
        x = ys[i] - torch.bmm(qs[i], x[..., None])[..., 0]
        xs[i] = x
    return torch.stack(xs, dim=1)


def block_thomas(a, b, c, d):
    """Batched block-tridiagonal solve along axis 1, the JAX package's
    block_thomas: a, b, c (NL, L, V, V) sub/main/super diagonal blocks
    (a[:, 0] and c[:, L-1] ignored), d (NL, L, V). Returns x (NL, L, V)."""
    return thomas_solve(a, thomas_factor(a, b, c), d)
