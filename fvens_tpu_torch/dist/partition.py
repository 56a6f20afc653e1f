"""Host-side mesh partitioning for domain decomposition over ranks.

The port's copy of the JAX package's dist/partition.py, the equivalent of
the reference's partitioners + mesh restriction (FVENS
src/mesh/meshpartitioning.cpp:24-461):

  - cells are split into D parts (greedy BFS growth over the cell adjacency,
    balanced by cell count, then KL/FM boundary refinement; the reference's
    Scotch/trivial partitioners play this role),
  - each part gets a LOCAL compiled mesh: its own cells first, one layer of
    halo cells after (the reference's connectivity ghost cells), with
    cross-partition faces REDUNDANTLY present in both parts
    (flow_spatial.cpp:499-502),
  - halo exchange = R rounds of point-to-point messages, each round a
    partial permutation of the parts (_neighbor_schedule; dist/comm.py
    sends them over torch.distributed), replacing L2TraceVector and PETSc
    ghosted Vecs (src/linalg/tracevector.cpp:32-320).

Every part is padded to the same NC_local, NF_local, max_nbf and color
table shape, as the JAX package pads its slabs for shard_map: part p here
equals slab p of the JAX bundle, array for array. Nothing in a per-rank
run needs the common shapes; they are kept for that parity and cost a few
padded rows.

Local face layout per part: physical boundary faces [0, max_nbf) (inert
padding after the part's own bfaces), then interior + cross faces, then inert
padding to NF_local.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import BC_EXTRAPOLATION, BC_NAMES, BC_PERIODIC
from ..mesh.device_mesh import (MAXNF, CompiledMesh, _round_up,
                                build_slot_arrays, greedy_coloring)
from ..mesh.geometry import compute_geometry
from ..mesh.reader import MeshData
from ..mesh.topology import build_topology, compute_periodic_map


@dataclasses.dataclass(frozen=True)
class PartMaps:
    """One part's halo exchange maps on its device (dist/comm.py reads
    them).

    pp_send/pp_recv: (R, max_pair) int64 local cells to pack / local slots
    to fill in round r (pp_recv == NC where padding); pp_perms: the R
    rounds' (src, dst) part pairs; send_to/recv_from: this part's partner
    in each round (-1: none) and send_len/recv_len the exact cell counts.
    send_idx (max_send,), halo_slots and halo_src (max_halo,): the
    all-gather encoding (halo_src indexes the flattened (D * max_send)
    gathered buffer; halo_slots == NC where padding)."""
    rank: int
    n_parts: int
    NC: int
    pp_send: torch.Tensor
    pp_recv: torch.Tensor
    pp_perms: tuple
    send_to: tuple
    send_len: tuple
    recv_from: tuple
    recv_len: tuple
    send_idx: torch.Tensor
    halo_slots: torch.Tensor
    halo_src: torch.Tensor
    max_send: int


@dataclasses.dataclass(frozen=True)
class ShardedMeshBundle:
    """Every part's local mesh and exchange maps as host (NumPy) arrays,
    each leading with the part axis D, in the JAX package's layout.

    Two halo-exchange encodings are carried:
      - the neighbour schedule (pp_*): R rounds of point-to-point sends,
        each round a partial permutation of the parts; per-part traffic is
        O(its own partition boundary), the mapping of the reference's
        L2TraceVector Isend/Irecv pairs (src/linalg/tracevector.cpp:
        214-320). The solver's path;
      - all-gather maps (send_idx/halo_slots/halo_src): every part receives
        every other's packed buffer; O(D * max_send) per part. Kept as the
        A/B check of the schedule.
    """
    fields: dict                  # CompiledMesh field -> (D, ...) array
    NC: int                       # NC_local (every part)
    NF: int                       # NF_local
    n_bfaces: int                 # max_nbf
    n_ifaces: int
    n_colors: int
    send_idx: np.ndarray          # (D, max_send) local cell ids to pack
    halo_slots: np.ndarray        # (D, max_halo) local cell slots to fill
    halo_src: np.ndarray          # (D, max_halo) index into the flattened
    #                               all-gathered buffer (D*max_send)
    pp_send: np.ndarray           # (D, R, max_pair) local cells to pack for
    #                               round r (pad 0; receiver drops them)
    pp_recv: np.ndarray           # (D, R, max_pair) local slots to fill in
    #                               round r (pad NC_local -> dropped)
    pp_perms: tuple               # R (src, dst) pair lists
    own_counts: np.ndarray        # (D,) number of owned cells per part
    own_gid: np.ndarray           # (D, NC_local) local slot -> global cell
    n_parts: int
    n_cells_global: int
    max_send: int
    max_halo: int
    cut_faces: int = 0            # partition edge cut (quality metric)
    halo_cells: int = 0           # total ghost cells over all parts (the
    #                               exact per-exchange comm volume in cells)

    def part(self, p: int, device="cuda", dtype=torch.float64) -> tuple:
        """(CompiledMesh, PartMaps) of part p on `device`: float fields in
        `dtype`, index fields int64. The mesh's n_cells is the part's own
        cell count (own cells are its first rows)."""
        fields = {k: a[p] for k, a in self.fields.items()}
        mesh = CompiledMesh.from_numpy(dict(
            fields, n_cells=int(self.own_counts[p]), n_bfaces=self.n_bfaces,
            n_ifaces=self.n_ifaces, NC=self.NC, NF=self.NF,
            n_colors=self.n_colors), dtype=dtype, device=device)
        R = len(self.pp_perms)
        send_to, recv_from = [-1] * R, [-1] * R
        send_len, recv_len = [0] * R, [0] * R
        for r, perm in enumerate(self.pp_perms):
            for src, dst in perm:
                n = int((self.pp_recv[dst, r] < self.NC).sum())
                if src == p:
                    send_to[r], send_len[r] = dst, n
                if dst == p:
                    recv_from[r], recv_len[r] = src, n

        def idx(a):
            return torch.as_tensor(a[p], dtype=torch.int64, device=device)
        maps = PartMaps(
            rank=p, n_parts=self.n_parts, NC=self.NC,
            pp_send=idx(self.pp_send), pp_recv=idx(self.pp_recv),
            pp_perms=self.pp_perms, send_to=tuple(send_to),
            send_len=tuple(send_len), recv_from=tuple(recv_from),
            recv_len=tuple(recv_len), send_idx=idx(self.send_idx),
            halo_slots=idx(self.halo_slots), halo_src=idx(self.halo_src),
            max_send=self.max_send)
        return mesh, maps


def greedy_partition(esuel: np.ndarray, nfael: np.ndarray, nparts: int
                     ) -> np.ndarray:
    """Balanced BFS-growth partition of the cell adjacency graph."""
    from ..native import greedy_partition_native
    nat = greedy_partition_native(esuel, np.asarray(nfael, dtype=np.int64),
                                  nparts)
    if nat is not None:
        return nat
    from collections import deque
    nelem = esuel.shape[0]
    part = np.full(nelem, -1, dtype=np.int64)
    target = -(-nelem // nparts)
    seed = 0
    for p in range(nparts):
        while seed < nelem and part[seed] >= 0:
            seed += 1
        if seed >= nelem:
            break
        frontier = deque([seed])
        count = 0
        while frontier and count < target:
            c = frontier.popleft()
            if part[c] >= 0:
                continue
            part[c] = p
            count += 1
            for k in range(nfael[c]):
                nb = esuel[c, k]
                if 0 <= nb < nelem and part[nb] < 0:
                    frontier.append(nb)
    part[part < 0] = nparts - 1
    return part


def edge_cut(esuel: np.ndarray, nfael: np.ndarray, part: np.ndarray) -> int:
    """Number of adjacency edges crossing partition boundaries (each
    undirected edge counted once) — the quality metric Scotch minimizes in
    the reference (meshpartitioning.cpp:432-461)."""
    nelem = esuel.shape[0]
    cut = 0
    for k in range(esuel.shape[1]):
        nb = esuel[:, k]
        valid = (np.arange(nelem) < nelem) & (nb >= 0) & (nb < nelem) \
            & (np.arange(nelem) < nb)       # count each pair once
        valid &= k < nfael
        cut += int((part[np.flatnonzero(valid)]
                    != part[nb[np.flatnonzero(valid)]]).sum())
    return cut


def refine_partition(esuel: np.ndarray, nfael: np.ndarray,
                     part: np.ndarray, nparts: int, max_passes: int = 8,
                     imbalance: float = 1.1) -> np.ndarray:
    """Greedy KL/FM-style boundary refinement: repeatedly move boundary
    cells to the neighbouring part with the largest positive edge-cut gain,
    under a size-balance constraint. Plays the role of Scotch's recursive
    refinement on top of the BFS growth (the reference delegates both to
    Scotch, meshpartitioning.cpp:432-461); monotone in the cut, so it can
    only improve the halo volume of the ppermute schedule."""
    nelem = esuel.shape[0]
    maxnf = esuel.shape[1]
    part = part.copy()
    counts = np.bincount(part, minlength=nparts)
    target = nelem / nparts
    lo = int(np.floor(target / imbalance))
    hi = int(np.ceil(target * imbalance))

    slot_valid = (np.arange(maxnf)[None, :] < np.asarray(nfael)[:, None])
    nb = np.where(slot_valid, esuel, -1)
    nb_ok = (nb >= 0) & (nb < nelem)

    for _ in range(max_passes):
        nbp = np.where(nb_ok, part[np.clip(nb, 0, nelem - 1)], -1)
        own = part[:, None]
        boundary = ((nbp >= 0) & (nbp != own)).any(axis=1)
        cand_cells = np.flatnonzero(boundary)
        moved = 0
        for c in cand_cells:
            p0 = part[c]
            if counts[p0] <= lo:
                continue
            # per-slot neighbour parts of c (recomputed against the live
            # part array so sequential moves never thrash)
            qs = [part[esuel[c, k]] for k in range(nfael[c])
                  if 0 <= esuel[c, k] < nelem]
            if not qs:
                continue
            d_own = sum(q == p0 for q in qs)
            best_q, best_gain = -1, 0
            for q in set(qs):
                if q == p0 or counts[q] >= hi:
                    continue
                gain = sum(x == q for x in qs) - d_own
                if gain > best_gain:
                    best_q, best_gain = q, gain
            if best_q >= 0:
                part[c] = best_q
                counts[p0] -= 1
                counts[best_q] += 1
                moved += 1
        if moved == 0:
            break
    return part


def partition_mesh(md: MeshData, bcs, nparts: int,
                   part: np.ndarray | None = None,
                   validate: bool = True) -> "ShardedMeshBundle":
    """Split `md` into `nparts` parts (the refined BFS partition, or the
    given `part` array: the global part of every cell) and build every
    part's local mesh and exchange maps on the host, padded to the JAX
    package's common per-part shapes. Returns a ShardedMeshBundle of NumPy
    arrays; ShardedMeshBundle.part puts one part on a device."""
    topo = build_topology(md)
    for bc in bcs:
        if BC_NAMES.get(bc.type) == BC_PERIODIC:
            compute_periodic_map(topo, md.coords, bc.marker, bc.periodic_axis)
    geom = compute_geometry(md, topo)
    if validate:
        from ..mesh.geometry import validate_geometry
        validate_geometry(md, geom, where="partition_mesh")
    nelem, nb = topo.nelem, topo.nbface

    if part is None:
        nfael = np.asarray(topo.nfael)
        part = greedy_partition(topo.esuel, nfael, nparts)
        # KL/FM boundary refinement on top of the BFS growth: the quality
        # role of Scotch in the reference (meshpartitioning.cpp:432-461) —
        # monotone in the edge cut, so halo volume only shrinks
        part = refine_partition(topo.esuel, nfael, part, nparts)

    fc = topo.f_cells
    fr = fc[:, 1].copy()
    fr[:nb] = np.where(fr[:nb] >= 0, fr[:nb], fc[:nb, 0])

    marker_map = {bc.marker: bc for bc in bcs}

    # ---- pass 1: own cells, local faces, halo cells -----------------------
    per_part = []
    for p in range(nparts):
        own = np.flatnonzero(part == p)
        own_set = np.zeros(nelem, dtype=bool)
        own_set[own] = True
        left_own = own_set[fc[:, 0]]
        right_own = np.zeros(fc.shape[0], dtype=bool)
        vr = fc[:, 1] >= 0
        right_own[vr] = own_set[fc[vr, 1]]
        fsel_b = np.flatnonzero(left_own[:nb])          # bfaces owned by left
        fsel_i = nb + np.flatnonzero(left_own[nb:] | right_own[nb:])
        cells_of = np.unique(np.concatenate(
            [fc[fsel_i, 0], fc[fsel_i, 1], fr[fsel_b]]))
        halo = cells_of[~own_set[cells_of]]
        per_part.append((own, halo, fsel_b, fsel_i))

    send_sets = []
    for p in range(nparts):
        need = (np.concatenate([per_part[q][1] for q in range(nparts)
                                if q != p])
                if nparts > 1 else np.empty(0, np.int64))
        mine = need[part[need] == p] if need.size else need
        send_sets.append(np.unique(mine))

    max_send = max(1, max(s.size for s in send_sets))
    max_halo = max(1, max(pp[1].size for pp in per_part))
    NCl = _round_up(max(1, max(pp[0].size + pp[1].size for pp in per_part)), 8)
    max_nbf = max(1, max(pp[2].size for pp in per_part))
    NFl = _round_up(max_nbf + max(pp[3].size for pp in per_part), 8)

    send_pos = {}
    for p, s in enumerate(send_sets):
        for i, c in enumerate(s):
            send_pos[(p, int(c))] = i

    send_stack = np.zeros((nparts, max_send), np.int32)
    slot_stack = np.zeros((nparts, max_halo), np.int32)
    src_stack = np.zeros((nparts, max_halo), np.int32)
    own_counts = np.zeros(nparts, np.int64)
    own_gid = np.full((nparts, NCl), -1, np.int64)   # local slot -> global id

    fields = []
    g2l_list = []
    for p in range(nparts):
        own, halo, fsel_b, fsel_i = per_part[p]
        own_counts[p] = own.size
        own_gid[p, :own.size] = own
        loc_of = {int(c): i for i, c in enumerate(own)}
        for i, c in enumerate(halo):
            loc_of[int(c)] = own.size + i
        n_loc = own.size + halo.size
        allc = np.concatenate([own, halo]).astype(np.int64)

        nfb, nfi = fsel_b.size, fsel_i.size
        # local face id -> global face id, -1 for padding
        lf2g = np.full(NFl, -1, np.int64)
        lf2g[:nfb] = fsel_b
        lf2g[max_nbf:max_nbf + nfi] = fsel_i
        valid_f = lf2g >= 0
        gsafe = np.where(valid_f, lf2g, 0)

        g2l_vec = np.full(nelem, -1, np.int64)
        g2l_vec[allc] = np.arange(n_loc)
        g2l_list.append(g2l_vec)

        f_left = np.where(valid_f, g2l_vec[fc[gsafe, 0]], 0).astype(np.int32)
        fr_loc = g2l_vec[fr[gsafe]]
        # right cell may be absent locally only for non-periodic bfaces
        f_right = np.where(valid_f & (fr_loc >= 0), fr_loc,
                           f_left).astype(np.int32)

        def gatherf(garr, fill=0.0):
            out = np.full((NFl,) + garr.shape[1:], fill, dtype=np.float64)
            out[valid_f] = garr[lf2g[valid_f]]
            return out

        f_normal = gatherf(geom.f_normal)
        f_normal[~valid_f, 0] = 1.0
        f_len = gatherf(geom.f_len)
        f_mid = gatherf(geom.f_mid)
        # right-state reconstruction points (partner midpoint on periodic)
        rpoint_g = geom.f_mid.copy()
        perg = np.flatnonzero(topo.periodic_partner >= 0)
        if perg.size:
            rpoint_g[perg] = geom.f_mid[topo.periodic_partner[perg]]
        f_rpoint = gatherf(rpoint_g)
        rcl_g = geom.rc[fc[:, 0]]
        rcr_g = geom.rc[np.maximum(fr, 0)]
        rcr_g[:nb] = geom.rcbp
        f_rcl = gatherf(rcl_g)
        f_rcr = gatherf(rcr_g)
        drv = f_rcr - f_rcl
        f_dist = np.sqrt((drv ** 2).sum(1))
        f_dist = np.where(f_dist == 0, 1.0, f_dist)
        f_dru = drv / f_dist[:, None]
        dl = np.sqrt(((f_mid - f_rcl) ** 2).sum(1)); dl[dl == 0] = 1.0
        dr = np.sqrt(((f_mid - f_rcr) ** 2).sum(1)); dr[dr == 0] = 1.0
        il, ir = 1.0 / dl, 1.0 / dr
        f_wl = il / (il + ir); f_wr = ir / (il + ir)
        f_dr = f_rcl - f_rcr
        d2 = (f_dr ** 2).sum(1)
        f_w2 = np.where(valid_f & (d2 > 0),
                        1.0 / np.where(d2 == 0, 1.0, d2), 0.0)

        area = np.ones(NCl); rc = np.zeros((NCl, 2))
        cmask = np.zeros(NCl); clen = np.ones(NCl)
        area[:n_loc] = geom.area[allc]
        rc[:n_loc] = geom.rc[allc]
        clen[:n_loc] = geom.clength[allc]
        cmask[:own.size] = 1.0

        cell_faces = np.zeros((NCl, MAXNF), np.int32)
        cell_fsign = np.zeros((NCl, MAXNF))
        cell_nbrs = np.tile(np.arange(NCl, dtype=np.int32)[:, None],
                            (1, MAXNF))
        nbr_mask = np.zeros((NCl, MAXNF))

        # map: global face -> local face index
        gf2lf = np.full(fc.shape[0], -1, np.int64)
        gf2lf[fsel_b] = np.arange(nfb)
        gf2lf[fsel_i] = max_nbf + np.arange(nfi)

        ef = topo.elemface
        for li in range(n_loc):
            c = int(allc[li])
            for k in range(int(topo.nfael[c])):
                gf = int(ef[c, k])
                lf = int(gf2lf[gf]) if gf >= 0 else -1
                if lf < 0:
                    continue
                j = lf
                isleft = int(fc[gf, 0]) == c
                cell_faces[li, k] = j
                cell_fsign[li, k] = 1.0 if isleft else -1.0
                if gf < nb:
                    partner = int(fr[gf])
                    if (topo.periodic_partner[gf] >= 0
                            and g2l_vec[partner] >= 0):
                        cell_nbrs[li, k] = g2l_vec[partner]
                        nbr_mask[li, k] = 1.0
                    else:
                        cell_nbrs[li, k] = NCl + j      # boundary ghost slot
                        nbr_mask[li, k] = 0.0
                else:
                    other = int(fc[gf, 1] if isleft else fc[gf, 0])
                    lo = int(g2l_vec[other])
                    if lo >= 0:
                        cell_nbrs[li, k] = lo
                        nbr_mask[li, k] = 1.0
                    else:
                        cell_nbrs[li, k] = li
                        nbr_mask[li, k] = 0.0

        w2g = f_w2[cell_faces] * (cell_fsign != 0)
        drg = f_dr[cell_faces]
        V = np.einsum("ck,cki,ckj->cij", w2g, drg, drg)
        detV = V[:, 0, 0] * V[:, 1, 1] - V[:, 0, 1] * V[:, 1, 0]
        scale = (V[:, 0, 0] + V[:, 1, 1]) ** 2
        bad = ~(np.abs(detV) > 1e-10 * np.maximum(scale, 1e-30))
        V[bad] = np.eye(2)
        wls_vinv = np.linalg.inv(V)

        color_rows_p, color_counts_p, n_colors_p = greedy_coloring(
            cell_nbrs, nbr_mask, cmask > 0, NCl)

        bc_code = np.full(max_nbf, BC_EXTRAPOLATION, np.int32)
        bc_v0 = np.zeros(max_nbf); bc_v1 = np.zeros(max_nbf)
        bc_tag = np.full(max_nbf, -1, np.int32)
        for j, gf in enumerate(fsel_b):
            tag = int(topo.btags[gf, 0])
            bc = marker_map.get(tag)
            if bc is None:
                raise ValueError(f"no BC for marker {tag}")
            bc_code[j] = BC_NAMES[bc.type]
            if len(bc.values) > 0:
                bc_v0[j] = bc.values[0]
            if len(bc.values) > 1:
                bc_v1[j] = bc.values[1]
            bc_tag[j] = tag

        sn, sdr, sdist, slen, scode, sv0, sv1 = build_slot_arrays(
            f_normal, f_dru, f_dist, f_len, bc_code, bc_v0, bc_v1, max_nbf,
            cell_faces, cell_fsign)

        s = send_sets[p]
        if s.size:
            send_stack[p, :s.size] = g2l_vec[s]
        for i, c in enumerate(halo):
            slot_stack[p, i] = own.size + i
            owner = int(part[c])
            src_stack[p, i] = owner * max_send + send_pos[(owner, int(c))]
        slot_stack[p, halo.size:] = NCl    # out of bounds -> dropped
        src_stack[p, halo.size:] = 0

        fields.append(dict(
            f_left=f_left, f_right=f_right, f_normal=f_normal, f_len=f_len,
            f_mid=f_mid, f_rpoint=f_rpoint, f_rcl=f_rcl, f_rcr=f_rcr,
            f_dr_unit=f_dru,
            f_dist=f_dist, f_wl=f_wl, f_wr=f_wr, f_w2=f_w2, f_dr=f_dr,
            area=area, inv_area=1.0 / area, rc=rc, cell_mask=cmask,
            cell_faces=cell_faces, cell_fsign=cell_fsign,
            cell_nbrs=cell_nbrs, nbr_mask=nbr_mask, wls_vinv=wls_vinv,
            clength=clen, bc_code=bc_code, bc_v0=bc_v0, bc_v1=bc_v1,
            bc_tag=bc_tag, color_rows=color_rows_p,
            color_counts=color_counts_p,
            slot_normal=sn, slot_dr_unit=sdr, slot_dist=sdist,
            slot_len=slen, slot_bc_code=scode, slot_v0=sv0, slot_v1=sv1,
        ))

    # pad per-part colorings to a common (n_colors, max_rows) shape
    n_colors = max(f["color_rows"].shape[0] for f in fields)
    max_rows = max(f["color_rows"].shape[1] for f in fields)
    for f in fields:
        cr = np.full((n_colors, max_rows), NCl - 1, np.int32)
        cc = np.zeros(n_colors, np.int32)
        r = f["color_rows"]; c = f["color_counts"]
        cr[: r.shape[0], : r.shape[1]] = r
        cc[: c.shape[0]] = c
        f["color_rows"] = cr
        f["color_counts"] = cc

    stack = {k: np.stack([f[k] for f in fields]) for k in fields[0]}
    stack = {k: a.astype(np.int32) if a.dtype.kind in "iu" else a
             for k, a in stack.items()}
    pp_send, pp_recv, pp_perms = _neighbor_schedule(
        per_part, part, g2l_list, nparts, NCl)

    return ShardedMeshBundle(
        fields=stack, NC=NCl, NF=NFl, n_bfaces=max_nbf,
        n_ifaces=NFl - max_nbf, n_colors=n_colors,
        send_idx=send_stack, halo_slots=slot_stack, halo_src=src_stack,
        pp_send=pp_send, pp_recv=pp_recv, pp_perms=pp_perms,
        own_counts=own_counts, own_gid=own_gid,
        n_parts=nparts, n_cells_global=nelem, max_send=max_send,
        max_halo=max_halo,
        cut_faces=edge_cut(topo.esuel, np.asarray(topo.nfael), part),
        halo_cells=int(sum(pp[1].size for pp in per_part)))


def halo_schedule_stats(bundle: ShardedMeshBundle, value_bytes: int = 4,
                        nvars: int = 4) -> dict:
    """Comm-volume accounting of the edge-coloured point-to-point
    schedule: per-exchange message count and payload bytes, cross-checked
    against the partition's halo and edge cut. The scheduled send volume
    must equal the total halo size exactly: every ghost cell is delivered
    by exactly one (owner -> user) message per exchange (the reference's
    L2TraceVector pairs each shared face once, tracevector.cpp:214-320).
    Raises ValueError where it does not."""
    recv = bundle.pp_recv                        # (D, R, max_pair)
    valid = recv < bundle.NC
    cells = int(valid.sum())
    msgs = int(valid.any(axis=2).sum())          # (part, round) pairs used
    halo_valid = int((bundle.halo_slots < bundle.NC).sum())
    if not cells == halo_valid == bundle.halo_cells:
        raise ValueError(f"scheduled sends {cells} != halo cells "
                         f"{halo_valid}/{bundle.halo_cells}")
    per_dev = valid.sum(axis=(1, 2))
    return {"rounds": int(recv.shape[1]),
            "messages_per_exchange": msgs,
            "halo_cells": cells,
            "cut_faces": int(bundle.cut_faces),
            "bytes_per_exchange": cells * nvars * value_bytes,
            "max_device_cells": int(per_dev.max()),
            "min_device_cells": int(per_dev.min())}


def _neighbor_schedule(per_part, part, g2l_list, nparts: int, NCl: int):
    """Point-to-point halo schedule: rounds of partial permutations.

    The directed neighbour graph (p -> q whenever q's halo contains cells
    owned by p) is greedily edge-coloured so each colour class ("round")
    has every part sending to at most one peer and receiving from at most
    one: one send and one receive per rank and round (dist/comm.py).
    R = chromatic index ~= max neighbour degree, independent of D;
    per-part traffic per matvec is
    O(its own partition boundary) instead of the all_gather's
    O(D * max_send). Replaces L2TraceVector's Isend/Irecv pairing
    (reference src/linalg/tracevector.cpp:214-320).
    """
    edges = []  # (src part, dst part, global cell ids ascending)
    for q in range(nparts):
        halo = per_part[q][1]
        if halo.size == 0:
            continue
        owners = part[halo]
        for p in np.unique(owners):
            edges.append((int(p), q, halo[owners == p]))

    rounds: list[list[int]] = []
    src_used: list[set] = []
    dst_used: list[set] = []
    for e, (p, q, _) in enumerate(edges):
        for r in range(len(rounds)):
            if p not in src_used[r] and q not in dst_used[r]:
                rounds[r].append(e)
                src_used[r].add(p)
                dst_used[r].add(q)
                break
        else:
            rounds.append([e])
            src_used.append({p})
            dst_used.append({q})

    R = max(1, len(rounds))
    max_pair = max([1] + [len(c) for _, _, c in edges])
    pp_send = np.zeros((nparts, R, max_pair), np.int32)
    pp_recv = np.full((nparts, R, max_pair), NCl, np.int32)  # pad: dropped
    perms = []
    for r in range(R):
        pairs = []
        for e in (rounds[r] if r < len(rounds) else []):
            p, q, cells = edges[e]
            pairs.append((p, q))
            pp_send[p, r, :cells.size] = g2l_list[p][cells]
            pp_recv[q, r, :cells.size] = g2l_list[q][cells]
        perms.append(tuple(pairs))
    return pp_send, pp_recv, tuple(perms)
