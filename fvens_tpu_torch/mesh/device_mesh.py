"""The device mesh: unstructured topology compiled to static padded SoA tensors.

PyTorch counterpart of the JAX package's mesh/device_mesh.py, with the same
field names, shapes and host compilation. The mesh is compiled ONCE on the
host (NumPy) into flat index maps and geometric coefficient arrays, padded
to multiples of 8; all numerics then run on these tensors:

    gather cell states by (f_left, f_right)
      -> pointwise flux functions over the face batch
      -> per-cell incidence gather-sums (cell_faces/cell_fsign) instead of
         atomic scatter-adds (flow_spatial.cpp:551-561 in the reference), so
         every sum is taken in the same order on every run.

Index fields are int64 (torch's native index type); float fields take the
`dtype` given to compile_mesh. Face ordering: physical-boundary faces first
[0, n_bfaces), then interior faces [n_bfaces, n_faces), then inert padding.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import BCSpec, BC_NAMES, BC_PERIODIC
from .geometry import compute_geometry
from .reader import MeshData
from .topology import build_topology, compute_periodic_map

MAXNF = 4  # max faces per cell in 2D (quad)

INDEX_FIELDS = ("f_left", "f_right", "cell_faces", "cell_nbrs", "color_rows",
                "color_counts", "slot_bc_code", "bc_code", "bc_tag")
META_FIELDS = ("n_cells", "n_bfaces", "n_ifaces", "NC", "NF", "n_colors")


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def greedy_coloring(cell_nbrs: np.ndarray, nbr_mask: np.ndarray,
                    active: np.ndarray, NC: int):
    """Greedy coloring of the cell adjacency graph (<=4 neighbours in 2D, so
    <=5 colors). Only `active` cells are colored; returns
    (color_rows (n_colors, max_rows) int32 padded with NC-1,
     color_counts (n_colors,), n_colors).

    Drives the multicolor block-SGS preconditioner: cells of one color share
    no faces, so a whole color updates in one batched step.
    """
    n = cell_nbrs.shape[0]
    from ..native import greedy_coloring_native
    nat = greedy_coloring_native(cell_nbrs, nbr_mask, active)
    if nat is not None:
        color, n_colors = nat
    else:
        color = np.full(n, -1, dtype=np.int64)
        for c in range(n):
            if not active[c]:
                continue
            used = set()
            for k in range(cell_nbrs.shape[1]):
                if nbr_mask[c, k] > 0:
                    nb = int(cell_nbrs[c, k])
                    if nb < n and color[nb] >= 0:
                        used.add(color[nb])
            col = 0
            while col in used:
                col += 1
            color[c] = col
        n_colors = max(1, int(color.max()) + 1)
    groups = [np.flatnonzero(color == c) for c in range(n_colors)]
    max_rows = max(1, max(g.size for g in groups))
    rows = np.full((n_colors, max_rows), NC - 1, dtype=np.int32)
    counts = np.zeros(n_colors, dtype=np.int32)
    for c, g in enumerate(groups):
        rows[c, : g.size] = g
        counts[c] = g.size
    return rows, counts, n_colors


def build_slot_arrays(f_normal, f_dr_unit, f_dist, f_len,
                      bc_code, bc_v0, bc_v1, n_bfaces,
                      cell_faces, cell_fsign):
    """Per-cell-slot face geometry with the owner's orientation baked in
    (see CompiledMesh.slot_* docs). NumPy, host-side."""
    cf = cell_faces
    s = cell_fsign
    sn = f_normal[cf] * s[..., None]
    sn[s == 0] = np.array([1.0, 0.0])
    sdr = f_dr_unit[cf] * s[..., None]
    sdist = f_dist[cf]
    slen = f_len[cf] * np.abs(s)
    nb = max(n_bfaces, 1)
    cfb = np.clip(cf, 0, nb - 1)
    is_b = (cf < n_bfaces) & (s != 0)
    code = np.where(is_b, bc_code[cfb], -1).astype(np.int32)
    # periodic slots couple to the partner cell like interior faces
    code = np.where(code == BC_PERIODIC, -1, code)
    v0 = np.where(is_b, bc_v0[cfb], 0.0)
    v1 = np.where(is_b, bc_v1[cfb], 0.0)
    return sn, sdr, sdist, slen, code, v0, v1


@dataclasses.dataclass(frozen=True)
class CompiledMesh:
    """Static SoA mesh tensors. Shapes: NC = padded cells, NF = padded faces,
    NB = n_bfaces (unpadded; boundary faces are the prefix of the face list).
    Index fields are int64, the rest take the mesh's float dtype.
    """

    # --- faces ---
    f_left: torch.Tensor      # (NF,) left cell
    f_right: torch.Tensor     # (NF,) right cell; for physical boundary
    #                           faces: the partner cell for periodic, else the
    #                           left cell itself (unused - BC supplies the state)
    f_normal: torch.Tensor    # (NF,2) unit normal, left -> right
    f_len: torch.Tensor       # (NF,) face length (0 on padding)
    f_mid: torch.Tensor       # (NF,2) face midpoint (quadrature point)
    f_rpoint: torch.Tensor    # (NF,2) point at which the RIGHT state is
    #                           reconstructed (the partner face's midpoint on
    #                           periodic faces)
    f_rcl: torch.Tensor       # (NF,2) left cell centre
    f_rcr: torch.Tensor       # (NF,2) right cell centre (ghost centre on bdry)
    f_dr_unit: torch.Tensor   # (NF,2) unit vector rcl -> rcr
    f_dist: torch.Tensor      # (NF,) |rcr - rcl|
    f_wl: torch.Tensor        # (NF,) inverse-distance interp weight, left
    f_wr: torch.Tensor        # (NF,) inverse-distance interp weight, right
    f_w2: torch.Tensor        # (NF,) least-squares weight 1/dist^2
    f_dr: torch.Tensor        # (NF,2) rcl - rcr (least-squares direction)

    # --- cells ---
    area: torch.Tensor        # (NC,)
    inv_area: torch.Tensor    # (NC,)
    rc: torch.Tensor          # (NC,2)
    cell_mask: torch.Tensor   # (NC,) 1.0 for real cells, 0.0 padding
    cell_faces: torch.Tensor  # (NC,4) face index of each local face
    cell_fsign: torch.Tensor  # (NC,4) +1 cell is left, -1 right, 0 padding
    cell_nbrs: torch.Tensor   # (NC,4) neighbour across local face; for a
    #                           physical boundary face: NC + bface index,
    #                           padding: self
    nbr_mask: torch.Tensor    # (NC,4) 1.0 if the neighbour is a real cell
    wls_vinv: torch.Tensor    # (NC,2,2) inverse least-squares LHS
    clength: torch.Tensor     # (NC,) characteristic length (Venkatakrishnan)
    color_rows: torch.Tensor  # (n_colors, max_color_rows) cell ids per color
    color_counts: torch.Tensor  # (n_colors,) real rows per color

    # --- per-cell-slot face geometry (slot (c,k) = local face k of cell c),
    # with the owner's orientation baked in: the slot flux is always
    # flux(u_c, u_nbr, slot_normal) * slot_len ---
    slot_normal: torch.Tensor   # (NC,4,2)
    slot_dr_unit: torch.Tensor  # (NC,4,2) sign * dr_unit (thin-layer dir)
    slot_dist: torch.Tensor     # (NC,4)
    slot_len: torch.Tensor      # (NC,4) face length, 0 on padding slots
    slot_bc_code: torch.Tensor  # (NC,4) BC code or -1 (interior)
    slot_v0: torch.Tensor       # (NC,4)
    slot_v1: torch.Tensor       # (NC,4)

    # --- physical boundary faces (prefix of the face list) ---
    bc_code: torch.Tensor     # (NB,) BC type code (config.BC_*)
    bc_v0: torch.Tensor       # (NB,) first BC parameter
    bc_v1: torch.Tensor       # (NB,) second BC parameter
    bc_tag: torch.Tensor      # (NB,) mesh marker

    # --- static metadata ---
    n_cells: int
    n_bfaces: int
    n_ifaces: int
    NC: int
    NF: int
    n_colors: int

    @property
    def n_faces(self) -> int:
        return self.n_bfaces + self.n_ifaces

    @property
    def dtype(self) -> torch.dtype:
        return self.area.dtype

    @property
    def device(self) -> torch.device:
        return self.area.device

    @property
    def h_param(self) -> float:
        """Mesh size parameter 1/sqrt(nelem) (aoutput.cpp:53)."""
        return 1.0 / float(np.sqrt(self.n_cells))

    def to(self, dtype: torch.dtype | None = None,
           device: torch.device | str | None = None) -> "CompiledMesh":
        """Cast the float fields to `dtype` (index fields stay int64) and/or
        move every field to `device`."""
        out = {}
        for name in tensor_fields():
            t = getattr(self, name)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype=dtype)
            if device is not None:
                t = t.to(device=device)
            out[name] = t
        return dataclasses.replace(self, **out)

    @classmethod
    def from_numpy(cls, fields: dict, dtype: torch.dtype,
                   device: torch.device | str) -> "CompiledMesh":
        """Build from host arrays keyed by field name (plus the META_FIELDS
        ints): index fields become int64, the rest `dtype`."""
        kw = {}
        for name in tensor_fields():
            a = np.asarray(fields[name])
            want = torch.int64 if name in INDEX_FIELDS else dtype
            kw[name] = torch.as_tensor(a).to(dtype=want, device=device)
        for name in META_FIELDS:
            kw[name] = int(fields[name])
        return cls(**kw)


def tensor_fields() -> tuple:
    return tuple(f.name for f in dataclasses.fields(CompiledMesh)
                 if f.name not in META_FIELDS)


def compile_mesh_arrays(md: MeshData, bcs: Sequence[BCSpec] = (),
                        pad_cells: int = 8, pad_faces: int = 8,
                        validate: bool = True) -> dict:
    """The host half of compile_mesh: every CompiledMesh field as a NumPy
    array (floats f64, indices int32, as the JAX package builds them),
    plus the META_FIELDS ints.

    validate=True (default) rejects degenerate input loudly (zero/negative
    areas, zero-length faces, NaN geometry) instead of emitting inf/NaN
    coefficient arrays — the reference's behaviour (ameshutils.cpp:127-151).
    """
    topo = build_topology(md)

    # periodic pairing mutates topo.f_cells right-cell entries
    for bc in bcs:
        if BC_NAMES.get(bc.type) == BC_PERIODIC:
            compute_periodic_map(topo, md.coords, bc.marker, bc.periodic_axis)

    geom = compute_geometry(md, topo)
    if validate:
        from .geometry import validate_geometry
        validate_geometry(md, geom, where="compile_mesh")

    nelem, nb, ni = topo.nelem, topo.nbface, topo.ninface
    nf = nb + ni
    NC = _round_up(max(nelem, 1), pad_cells)
    NF = _round_up(max(nf, 1), pad_faces)

    # ---- face arrays ----
    f_left = np.zeros(NF, np.int32)
    f_right = np.zeros(NF, np.int32)
    f_left[:nf] = topo.f_cells[:, 0]
    fr = topo.f_cells[:, 1].copy()
    fr[:nb] = np.where(fr[:nb] >= 0, fr[:nb], topo.f_cells[:nb, 0])
    f_right[:nf] = fr

    f_normal = np.zeros((NF, 2)); f_normal[:, 0] = 1.0
    f_normal[:nf] = geom.f_normal
    f_len = np.zeros(NF); f_len[:nf] = geom.f_len
    f_mid = np.zeros((NF, 2)); f_mid[:nf] = geom.f_mid
    f_rpoint = f_mid.copy()
    per = np.flatnonzero(topo.periodic_partner >= 0)
    if per.size:
        f_rpoint[per] = geom.f_mid[topo.periodic_partner[per]]

    f_rcl = np.zeros((NF, 2)); f_rcl[:nf] = geom.rc[topo.f_cells[:nf, 0]]
    f_rcr = np.zeros((NF, 2))
    f_rcr[:nb] = geom.rcbp                       # ghost centres (incl. periodic)
    if ni:
        f_rcr[nb:nf] = geom.rc[topo.f_cells[nb:nf, 1]]
    drv = f_rcr - f_rcl
    f_dist = np.sqrt((drv ** 2).sum(1))
    f_dist[nf:] = 1.0
    f_dist = np.where(f_dist == 0, 1.0, f_dist)
    f_dr_unit = drv / f_dist[:, None]

    # Green-Gauss inverse-distance interpolation weights from the face
    # midpoint to the two cell centres (agradientschemes.cpp:100-152)
    dl = np.sqrt(((f_mid - f_rcl) ** 2).sum(1))
    dr = np.sqrt(((f_mid - f_rcr) ** 2).sum(1))
    dl = np.where(dl == 0, 1.0, dl)
    dr = np.where(dr == 0, 1.0, dr)
    il, ir = 1.0 / dl, 1.0 / dr
    f_wl = il / (il + ir)
    f_wr = ir / (il + ir)
    f_wl[nf:] = 0.5; f_wr[nf:] = 0.5

    # least-squares weights (1/d^2) and directions (agradientschemes.cpp:243-310)
    f_dr = f_rcl - f_rcr
    d2 = (f_dr ** 2).sum(1)
    f_w2 = np.where(d2 > 0, 1.0 / np.where(d2 == 0, 1.0, d2), 0.0)
    f_w2[nf:] = 0.0

    # ---- cell arrays ----
    area = np.ones(NC); area[:nelem] = geom.area
    rc = np.zeros((NC, 2)); rc[:nelem] = geom.rc
    cell_mask = np.zeros(NC); cell_mask[:nelem] = 1.0
    clength = np.ones(NC); clength[:nelem] = geom.clength

    cell_faces = np.zeros((NC, MAXNF), np.int32)
    cell_fsign = np.zeros((NC, MAXNF))
    cell_nbrs = np.tile(np.arange(NC, dtype=np.int32)[:, None], (1, MAXNF))
    nbr_mask = np.zeros((NC, MAXNF))

    ef = topo.elemface  # (nelem, maxnfael)
    for k in range(ef.shape[1]):
        valid = ef[:, k] >= 0
        fidx = np.where(valid, ef[:, k], 0)
        isleft = topo.f_cells[fidx, 0] == np.arange(nelem)
        cell_faces[:nelem, k] = np.where(valid, fidx, 0)
        cell_fsign[:nelem, k] = np.where(valid, np.where(isleft, 1.0, -1.0), 0.0)
        nbr = np.where(isleft, topo.f_cells[fidx, 1], topo.f_cells[fidx, 0])
        is_phys_b = (fidx < nb) & valid
        # ghost slot for physical boundary neighbours: NC + bface index
        nbr = np.where(is_phys_b, NC + fidx, nbr)
        cell_nbrs[:nelem, k] = np.where(valid, nbr, np.arange(nelem))
        nbr_mask[:nelem, k] = np.where(valid & ~is_phys_b, 1.0, 0.0)

    # weighted-least-squares LHS: V[c] = sum_f w2 * dr dr^T over the cell's
    # faces, inverted once (agradientschemes.cpp:228-318)
    w2g = f_w2[cell_faces] * (cell_fsign != 0)          # (NC,4)
    drg = f_dr[cell_faces]                              # (NC,4,2)
    V = np.einsum("ck,cki,ckj->cij", w2g, drg, drg)
    # padded / degenerate cells: identity to keep inverses finite
    detV = V[:, 0, 0] * V[:, 1, 1] - V[:, 0, 1] * V[:, 1, 0]
    scale = (V[:, 0, 0] + V[:, 1, 1]) ** 2
    bad = ~(np.abs(detV) > 1e-10 * np.maximum(scale, 1e-30))
    V[bad] = np.eye(2)
    wls_vinv = np.linalg.inv(V)

    # ---- boundary conditions ----
    bc_code = np.zeros(max(nb, 1), np.int32)
    bc_v0 = np.zeros(max(nb, 1))
    bc_v1 = np.zeros(max(nb, 1))
    bc_tag = np.zeros(max(nb, 1), np.int32)
    if nb:
        bc_tag[:nb] = topo.btags[:, 0]
        marker_map = {bc.marker: bc for bc in bcs}
        for ib in range(nb):
            bc = marker_map.get(int(bc_tag[ib]))
            if bc is None:
                raise ValueError(f"no BC specified for marker {int(bc_tag[ib])}")
            bc_code[ib] = BC_NAMES[bc.type]
            if len(bc.values) > 0:
                bc_v0[ib] = bc.values[0]
            if len(bc.values) > 1:
                bc_v1[ib] = bc.values[1]

    color_rows, color_counts, n_colors = greedy_coloring(
        cell_nbrs, nbr_mask, cell_mask > 0, NC)

    sn, sdr, sdist, slen, scode, sv0, sv1 = build_slot_arrays(
        f_normal, f_dr_unit, f_dist, f_len, bc_code, bc_v0, bc_v1, nb,
        cell_faces, cell_fsign)

    return dict(
        f_left=f_left, f_right=f_right, f_normal=f_normal,
        f_len=f_len, f_mid=f_mid, f_rpoint=f_rpoint,
        f_rcl=f_rcl, f_rcr=f_rcr,
        f_dr_unit=f_dr_unit, f_dist=f_dist, f_wl=f_wl,
        f_wr=f_wr, f_w2=f_w2, f_dr=f_dr,
        area=area, inv_area=1.0 / area, rc=rc,
        cell_mask=cell_mask, cell_faces=cell_faces,
        cell_fsign=cell_fsign, cell_nbrs=cell_nbrs,
        nbr_mask=nbr_mask, wls_vinv=wls_vinv, clength=clength,
        color_rows=color_rows, color_counts=color_counts,
        slot_normal=sn, slot_dr_unit=sdr, slot_dist=sdist,
        slot_len=slen, slot_bc_code=scode, slot_v0=sv0,
        slot_v1=sv1,
        bc_code=bc_code, bc_v0=bc_v0, bc_v1=bc_v1, bc_tag=bc_tag,
        n_cells=nelem, n_bfaces=nb, n_ifaces=ni, NC=NC, NF=NF,
        n_colors=n_colors,
    )


def compile_mesh(md: MeshData, bcs: Sequence[BCSpec] = (),
                 dtype: torch.dtype = torch.float64,
                 device: torch.device | str = "cuda",
                 pad_cells: int = 8, pad_faces: int = 8,
                 validate: bool = True) -> CompiledMesh:
    """Compile raw mesh + BC spec into tensors of `dtype` on `device` (the
    card unless the caller asks for the CPU)."""
    arrays = compile_mesh_arrays(md, bcs, pad_cells=pad_cells,
                                 pad_faces=pad_faces, validate=validate)
    return CompiledMesh.from_numpy(arrays, dtype=dtype, device=device)
