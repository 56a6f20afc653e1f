"""Algebraic (aggregation) multigrid preconditioner for the block system,
the JAX package's solver/multigrid.py in PyTorch.

Design (as in the JAX package):
  - pairwise aggregation on the cell graph (Notay-style, two passes per
    level, so aggregates of about 4 cells) with a geometric strength
    measure w = face_len / centre_dist, host-side, once per mesh;
  - Galerkin coarse operators A_l = R A_{l-1} R^T with piecewise-constant
    R, built once per Newton step;
  - a V-cycle with block-Jacobi defect-correction sweeps as the smoother
    and, on the coarsest level, a dense LU solve where it has at most
    _DENSE_COARSE_MAX unknowns (else more sweeps).

The JAX package sums parent blocks into coarse ones (and fine residuals
into aggregates) with jax.ops.segment_sum. A scatter-add on the card
(index_add_) adds in an order that changes from run to run, and so would
the trajectory. Here every sum is a gather-sum over a member list fixed on
the host (GatherSum): member j of every target is added in the j-th pass,
members in ascending source order, which is the order the JAX package's
segment_sum adds them on the CPU, and the same on every run on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .linear import block_jacobi_inverse


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class GatherSum:
    """segment_sum(x, ids, n)[:n] as a fixed-width gather-sum: `members`
    (W, n) holds, for each target, its source rows in ascending order,
    padded with the index of an appended zero row (len(x))."""
    members: torch.Tensor        # (W, n) int64

    @classmethod
    def build(cls, ids: np.ndarray, n: int, device) -> "GatherSum":
        """The member lists of segment ids `ids` (one per source row; ids
        outside [0, n) are dropped, as segment_sum drops the segments past
        n after the [:-1] cut)."""
        ids = np.asarray(ids, dtype=np.int64)
        src = np.flatnonzero((ids >= 0) & (ids < n))
        tgt = ids[src]
        order = np.argsort(tgt, kind="stable")      # sources stay ascending
        src, tgt = src[order], tgt[order]
        counts = np.bincount(tgt, minlength=n)
        W = max(1, int(counts.max()) if counts.size else 1)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(src.size) - first[tgt]
        members = np.full((W, n), ids.shape[0], np.int64)
        members[rank, tgt] = src
        return cls(torch.as_tensor(members, device=device))

    def __call__(self, x):
        """(n,) + x.shape[1:] sums of the rows of x."""
        xe = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        acc = xe[self.members[0]]
        for j in range(1, self.members.shape[0]):
            acc = acc + xe[self.members[j]]
        return acc


@dataclasses.dataclass(frozen=True)
class MGLevel:
    """One coarsening step: parent level (Np cells, Sp neighbour slots)
    -> this level (NCp padded cells, S neighbour slots)."""
    agg: torch.Tensor        # (Np,) int64 coarse cell of each parent cell;
    #                          parent padding rows point at NCp (dump row)
    tgt: torch.Tensor        # (Np, Sp+1) int64 flat index into
    #                          NCp*(S+1) coarse slot blocks (diag slot 0);
    #                          dropped/zero parent slots -> NCp*(S+1) (dump)
    c_mask: torch.Tensor     # (NCp,) 1.0 real coarse cell, 0.0 padding
    c_nbrs: torch.Tensor     # (NCp, S) int64 coarse neighbours
    #                          (self-padded, clamped in range)
    c_nbr_mask: torch.Tensor  # (NCp, S) 1.0 where a real coarse edge
    NCp: int                 # padded coarse cell count
    S: int                   # coarse neighbour slots
    galerkin_sum: GatherSum  # parent slot blocks -> coarse slot blocks
    restrict_sum: GatherSum  # parent rows -> coarse rows


@dataclasses.dataclass(frozen=True)
class MGHierarchy:
    levels: tuple            # tuple[MGLevel]


def _pairwise_pass(nbrs, mask, w, n_real):
    """One greedy strongest-neighbour matching pass (host). Returns
    (agg (n_real,) int64, n_agg). Cells are visited in index order."""
    from ..native import pairwise_aggregate_native
    nat = pairwise_aggregate_native(nbrs, mask, w, n_real)
    if nat is not None:
        return nat
    agg = np.full(n_real, -1, dtype=np.int64)
    na = 0
    S = nbrs.shape[1]
    for c in range(n_real):
        if agg[c] >= 0:
            continue
        best, bw = -1, 0.0
        for k in range(S):
            if mask[c, k] <= 0:
                continue
            nb = int(nbrs[c, k])
            if nb >= n_real or agg[nb] >= 0:
                continue
            if w[c, k] > bw:
                best, bw = nb, w[c, k]
        agg[c] = na
        if best >= 0:
            agg[best] = na
        na += 1
    return agg, na


def _coarse_graph(nbrs, mask, w, agg, n_real, n_agg):
    """Aggregate the parent graph: coarse edges with summed weights.
    Returns (c_nbrs (n_agg, S), c_mask (n_agg, S), c_w (n_agg, S), S)."""
    S_p = nbrs.shape[1]
    ci = np.repeat(agg[:n_real], S_p)
    nb = nbrs[:n_real].reshape(-1)
    valid = (mask[:n_real].reshape(-1) > 0) & (nb < n_real) & (nb >= 0)
    cj = np.where(valid, agg[np.clip(nb, 0, n_real - 1)], -1)
    keep = valid & (cj >= 0) & (cj != ci)
    ei, ej, ew = ci[keep], cj[keep], w[:n_real].reshape(-1)[keep]
    # unique directed coarse edges with accumulated weights
    key = ei * np.int64(n_agg) + ej
    order = np.argsort(key, kind="stable")
    key_s, ei_s, ej_s, ew_s = key[order], ei[order], ej[order], ew[order]
    uniq, first = np.unique(key_s, return_index=True)
    wsum = (np.add.reduceat(ew_s, first) if uniq.size
            else np.zeros(0))
    ui, uj = ei_s[first], ej_s[first]
    deg = np.bincount(ui, minlength=n_agg) if ui.size else np.zeros(
        n_agg, np.int64)
    S = max(1, int(deg.max()) if deg.size else 1)
    c_nbrs = np.tile(np.arange(n_agg, dtype=np.int64)[:, None], (1, S))
    c_w = np.zeros((n_agg, S))
    c_msk = np.zeros((n_agg, S))
    slot = np.zeros(n_agg, dtype=np.int64)
    for e in range(ui.size):
        i = ui[e]
        k = slot[i]
        c_nbrs[i, k] = uj[e]
        c_w[i, k] = wsum[e]
        c_msk[i, k] = 1.0
        slot[i] += 1
    return c_nbrs, c_msk, c_w, S


def _slot_map(nbrs_p, mask_p, agg, c_nbrs, c_msk, n_real, n_agg,
              NCp, S, Np):
    """Flat Galerkin scatter map: parent slot blocks (Np, Sp+1) -> coarse
    flat index in NCp*(S+1) (+ dump NCp*(S+1))."""
    Sp = nbrs_p.shape[1]
    dump = NCp * (S + 1)
    tgt = np.full((Np, Sp + 1), dump, dtype=np.int64)
    slot_of = {}
    for i in range(n_agg):
        for k in range(S):
            if c_msk[i, k] > 0:
                slot_of[(i, int(c_nbrs[i, k]))] = k + 1
    for c in range(n_real):
        I = int(agg[c])
        tgt[c, 0] = I * (S + 1)                   # diagonal -> diagonal
        for k in range(Sp):
            if mask_p[c, k] <= 0:
                continue
            nb = int(nbrs_p[c, k])
            if nb >= n_real:
                continue
            J = int(agg[nb])
            if J == I:
                tgt[c, k + 1] = I * (S + 1)       # intra-aggregate -> diag
            else:
                ks = slot_of.get((I, J))
                if ks is not None:
                    tgt[c, k + 1] = I * (S + 1) + ks
    return tgt


def build_hierarchy(mesh, n_levels: int = 3, min_coarse: int = 32,
                    passes: int = 2) -> MGHierarchy:
    """Host-side hierarchy construction from a CompiledMesh, its tensors
    on the mesh's device.

    n_levels counts coarsening steps (a 2-level method has n_levels=1).
    Stops early once a level would go below `min_coarse` cells."""
    dev = mesh.cell_nbrs.device
    nbrs = mesh.cell_nbrs.cpu().numpy().astype(np.int64)
    mask = mesh.nbr_mask.cpu().numpy().astype(np.float64)
    n_real = mesh.n_cells
    Np = mesh.NC
    # geometric strength: face length / centre distance
    w = (mesh.slot_len.cpu().numpy()
         / np.maximum(mesh.slot_dist.cpu().numpy(), 1e-300))
    w = w * mask                       # ghost/padding slots are not edges

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    levels = []
    for _ in range(n_levels):
        if n_real <= min_coarse:
            break
        # double pairwise aggregation: compose `passes` matchings
        agg = np.arange(n_real, dtype=np.int64)
        cur_nbrs, cur_mask, cur_w, cur_real = nbrs, mask, w, n_real
        for _p in range(passes):
            a1, na = _pairwise_pass(cur_nbrs, cur_mask, cur_w, cur_real)
            agg = a1[agg]
            cur_nbrs, cur_mask, cur_w, _S1 = _coarse_graph(
                cur_nbrs, cur_mask, cur_w, a1, cur_real, na)
            cur_real = na
            if na <= min_coarse:
                break
        n_agg = cur_real
        c_nbrs, c_msk, c_w = cur_nbrs, cur_mask, cur_w
        S = c_nbrs.shape[1]
        NCp = _round_up(max(n_agg, 1), 8)

        agg_full = np.full(Np, NCp, dtype=np.int64)       # padding -> dump
        agg_full[:n_real] = agg
        tgt = _slot_map(nbrs, mask, agg, c_nbrs, c_msk, n_real, n_agg,
                        NCp, S, Np)

        c_nbrs_pad = np.tile(np.arange(NCp, dtype=np.int64)[:, None],
                             (1, S))
        c_nbrs_pad[:n_agg] = np.clip(c_nbrs, 0, NCp - 1)
        c_msk_pad = np.zeros((NCp, S))
        c_msk_pad[:n_agg] = c_msk
        c_mask_arr = np.zeros(NCp)
        c_mask_arr[:n_agg] = 1.0

        levels.append(MGLevel(
            agg=t(agg_full), tgt=t(tgt), c_mask=t(c_mask_arr, torch.float64),
            c_nbrs=t(c_nbrs_pad), c_nbr_mask=t(c_msk_pad, torch.float64),
            NCp=NCp, S=S,
            galerkin_sum=GatherSum.build(tgt.reshape(-1), NCp * (S + 1),
                                         dev),
            restrict_sum=GatherSum.build(agg_full, NCp, dev)))

        # next iteration coarsens this level (re-padded to NCp rows)
        nbrs = np.zeros((NCp, S), np.int64)
        nbrs[:n_agg] = np.clip(c_nbrs, 0, max(n_agg - 1, 0))
        mask = np.zeros((NCp, S))
        mask[:n_agg] = c_msk
        w = np.zeros((NCp, S))
        w[:n_agg] = c_w * c_msk
        n_real, Np = n_agg, NCp
    return MGHierarchy(levels=tuple(levels))


def _galerkin(level: MGLevel, D, N):
    """Coarse slot blocks from parent blocks, one gather-sum."""
    V = D.shape[-1]
    blocks = torch.cat([D[:, None], N], dim=1)            # (Np, Sp+1, V, V)
    cb = level.galerkin_sum(blocks.reshape(-1, V, V))
    cb = cb.reshape(level.NCp, level.S + 1, V, V)
    Dc = cb[:, 0]
    eye = torch.eye(V, dtype=D.dtype, device=D.device)
    Dc = Dc + (1.0 - level.c_mask.to(D.dtype))[:, None, None] * eye
    Nc = cb[:, 1:] * level.c_nbr_mask.to(D.dtype)[..., None, None]
    return Dc, Nc


#: coarsest-level dense direct solve size cap (unknowns = cells * NVARS);
#: above this the coarsest level takes smoother sweeps
_DENSE_COARSE_MAX = 4096


def _densify(D, N, nbrs):
    """Slot-block operator -> dense (NC*V, NC*V). Masked neighbour slots
    carry zero blocks and self-pointing indices; real slots of a row are
    distinct coarse edges, so the accumulation adds exact zeros wherever
    two blocks meet and its order does not matter."""
    NC, V = D.shape[0], D.shape[-1]
    A = torch.zeros((NC, NC, V, V), dtype=D.dtype, device=D.device)
    ar = torch.arange(NC, device=D.device)
    A[ar, ar] = D
    rows = torch.repeat_interleave(ar, N.shape[1])
    A.index_put_((rows, nbrs.reshape(-1)), N.reshape(-1, V, V),
                 accumulate=True)
    return A.permute(0, 2, 1, 3).reshape(NC * V, NC * V)


def make_mg_preconditioner(mesh, jac, hierarchy: MGHierarchy,
                           nu1: int = 2, nu2: int = 2,
                           coarse_sweeps: int = 10, cycles: int = 1):
    """Returns pc(v) ~= J^-1 v: `cycles` V(nu1,nu2)-cycles.

    jac: fine BlockJacobian with the pseudo-time term already added. The
    coarse Galerkin operators and the folded D^-1 N are built here, once
    per Newton step.

    The coarsest level is solved exactly (dense LU) when small enough: at
    high CFL the Jacobian loses diagonal dominance and Jacobi-form sweeps
    can diverge, which would poison the whole correction. The correction
    scale omega stays a device scalar: the V-cycle never reads the card."""
    from .linear import _nbrs_in_range

    dtp = jac.D.dtype

    lev_ops = []          # (Dinv, DN, D, N, nbrs, lv-or-None)
    D, N = jac.D, jac.N
    nbrs = _nbrs_in_range(mesh)
    for lv in hierarchy.levels:
        Dinv = block_jacobi_inverse(D)
        DN = torch.einsum("cij,ckjl->ckil", Dinv, N)
        lev_ops.append((Dinv, DN, D, N, nbrs, lv))
        D, N = _galerkin(lv, D, N)
        nbrs = lv.c_nbrs
    Dinv = block_jacobi_inverse(D)
    DN = torch.einsum("cij,ckjl->ckil", Dinv, N)
    lev_ops.append((Dinv, DN, D, N, nbrs, None))
    nlev = len(lev_ops)

    V = jac.D.shape[-1]
    coarse_dense = D.shape[0] * V <= _DENSE_COARSE_MAX
    if coarse_dense:
        lu_c, piv_c = torch.linalg.lu_factor(_densify(D, N, nbrs))

        def coarse_solve(v):
            x = torch.linalg.lu_solve(lu_c, piv_c, v.reshape(-1, 1))
            return x.reshape(v.shape)

    def smooth(Dinv, DN, nbrs, v, z, n):
        """n block-Jacobi defect-correction sweeps from initial z (None=0).
        Exact identity: z + D^-1 (v - (D+N) z) = D^-1 v - (D^-1 N) z_nbr."""
        if n <= 0:
            return z if z is not None else torch.zeros_like(v)
        dv = torch.einsum("cij,cj->ci", Dinv, v)
        if z is None:
            z, n = dv, n - 1
        for _ in range(n):
            z = dv - torch.einsum("ckij,ckj->ci", DN, z[nbrs])
        return z

    def matvec(Dl, Nl, nbrs, x):
        blocks = torch.cat([Dl[:, None], Nl], dim=1)
        self_idx = torch.arange(Dl.shape[0], dtype=nbrs.dtype,
                                device=nbrs.device)
        idx = torch.cat([self_idx[:, None], nbrs], dim=1)
        return torch.einsum("ckij,ckj->ci", blocks, x[idx])

    zero = torch.zeros((), dtype=dtp, device=jac.D.device)

    def vcycle(l, v, z):
        Dinv, DN, Dl, Nl, nbrs, lv = lev_ops[l]
        if l == nlev - 1:
            if coarse_dense:
                return coarse_solve(v)            # exact: initial z moot
            return smooth(Dinv, DN, nbrs, v, z, coarse_sweeps)
        z = smooth(Dinv, DN, nbrs, v, z, nu1)
        r = v - matvec(Dl, Nl, nbrs, z)
        zc = vcycle(l + 1, lv.restrict_sum(r), None)
        zc_ext = torch.cat([zc, zc.new_zeros((1,) + zc.shape[1:])])
        e = zc_ext[lv.agg]
        # residual-minimizing correction scale (nonsymmetric safeguard):
        # omega* = <r, Ae>/<Ae, Ae>, clipped to [0, 2]
        Ae = matvec(Dl, Nl, nbrs, e)
        den = torch.sum(Ae * Ae)
        omega = torch.where(den > 0, torch.sum(r * Ae)
                            / torch.clamp_min(den, 1e-300), zero)
        omega = torch.clamp(omega, 0.0, 2.0)
        z = z + omega * e
        return smooth(Dinv, DN, nbrs, v, z, nu2)

    def pc(v):
        z = vcycle(0, v, None)
        for _ in range(cycles - 1):
            z = vcycle(0, v, z)
        return z

    return pc
