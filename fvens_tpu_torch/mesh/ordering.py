"""Cell reordering strategies: reverse Cuthill-McKee and line ordering.

Reference: FVENS src/mesh/meshordering.cpp + ameshutils.cpp:246-288
(-mesh_reorder {rcm, line, line_rcm}). Orderings change only the host-side
cell numbering (data locality for block solvers / future line smoothers);
the device numerics are permutation-invariant by construction.

lineReorder (meshordering.cpp:33-56): find "lines" of strongly coupled cells
via the face-weight anisotropy ratio (max/min of 1/dist between cell
centres) and number each line's cells consecutively.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from .reader import MeshData
from .topology import build_topology
from .geometry import compute_geometry


def reorder_mesh(md: MeshData, perm: np.ndarray) -> MeshData:
    """Renumber cells of md by permutation `perm` (new index i holds old cell
    perm[i]), like UMesh::reorder_cells (mesh.cpp:85-100)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return MeshData(
        coords=md.coords,
        inpoel=md.inpoel[perm],
        nnode=md.nnode[perm],
        nfael=md.nfael[perm],
        bface=md.bface,
        nbtag=md.nbtag,
        ndtag=md.ndtag,
        vol_regions=(md.vol_regions[perm]
                     if md.vol_regions is not None else None),
    )


def rcm_ordering(md: MeshData) -> np.ndarray:
    """Reverse Cuthill-McKee over the cell adjacency graph."""
    topo = build_topology(md)
    n = md.nelem
    esuel = topo.esuel
    nfael = np.asarray(topo.nfael)
    deg = (esuel >= 0).sum(axis=1)
    visited = np.zeros(n, dtype=bool)
    order = []
    while len(order) < n:
        # lowest-degree unvisited seed
        cand = np.flatnonzero(~visited)
        seed = cand[np.argmin(deg[cand])]
        q = deque([seed])
        visited[seed] = True
        while q:
            c = q.popleft()
            order.append(c)
            nbrs = [esuel[c, k] for k in range(nfael[c])
                    if 0 <= esuel[c, k] < n and not visited[esuel[c, k]]]
            for nb in sorted(nbrs, key=lambda x: deg[x]):
                visited[nb] = True
                q.append(nb)
    return np.asarray(order[::-1], dtype=np.int64)


def _local_anisotropies(esuel, nfael, rc):
    """Per-cell real-neighbour coupling weights 1/dist(centres), normalized
    by the cell's minimum weight and sorted by decreasing weight
    (meshordering.cpp computeWeights :143-203)."""
    n = esuel.shape[0]
    aniso, nbrs = [], []
    for c in range(n):
        ws = []
        for k in range(nfael[c]):
            nb = esuel[c, k]
            if 0 <= nb < n:
                d = np.sqrt(((rc[c] - rc[nb]) ** 2).sum())
                ws.append((1.0 / d, int(nb)))
        if ws:
            minw = min(w for w, _ in ws)
            ws = sorted(((w / minw, nb) for w, nb in ws),
                        key=lambda t: -t[0])
        aniso.append([w for w, _ in ws])
        nbrs.append([nb for _, nb in ws])
    return aniso, nbrs


def find_lines_core(esuel, nfael, rc, seeds, threshold: float):
    """Strong-coupling line detection (meshordering.cpp findLines :205-262).

    Starting from each seed cell (the reference seeds from physical-boundary
    faces, in face order): while the current cell's max/min coupling ratio
    exceeds `threshold`, append it and step to its strongest not-yet-lined
    neighbour whose (normalized) weight also exceeds the threshold.
    Single-cell lines are discarded. Returns (lines, celline) where
    celline[c] is the line index of cell c or -1.
    """
    n = esuel.shape[0]
    aniso, nbrs = _local_anisotropies(esuel, nfael, rc)
    celline = np.full(n, -1, dtype=np.int64)
    lines: list[list[int]] = []
    for belem in seeds:
        cur = int(belem)
        if celline[cur] >= 0:
            continue
        linelems: list[int] = []
        end = False
        while not end:
            if aniso[cur] and aniso[cur][0] > threshold:
                linelems.append(cur)
                celline[cur] = len(lines)
            else:
                break
            end = True
            for w, nb in zip(aniso[cur], nbrs[cur]):
                if celline[nb] == -1 and w > threshold:
                    cur = nb
                    end = False
                    break
        if len(linelems) > 1:
            lines.append(linelems)
        elif len(linelems) == 1:
            celline[linelems[0]] = -1
    return lines, celline


def find_lines(md: MeshData, threshold: float):
    """findLines on a MeshData: seeds = boundary cells in boundary-face
    order (meshordering.cpp:216-218, gintfac(iface,0))."""
    topo = build_topology(md)
    geom = compute_geometry(md, topo)
    seeds = topo.f_cells[:topo.nbface, 0]
    return find_lines_core(topo.esuel, np.asarray(topo.nfael), geom.rc,
                           seeds, threshold)


def line_ordering(md: MeshData, anisotropy_threshold: float = 10.0
                  ) -> np.ndarray:
    """lineReorder (meshordering.cpp:33-56): cells of each line numbered
    consecutively, in the order the lines were found, followed by the
    remaining cells in natural order."""
    lines, celline = find_lines(md, anisotropy_threshold)
    order = [c for line in lines for c in line]
    order += [c for c in range(md.nelem) if celline[c] == -1]
    return np.asarray(order, dtype=np.int64)


def _genrcm(adj: list) -> list:
    """SPARSEPACK genrcm (the algorithm behind PETSc MatOrdering 'rcm'):
    per connected component, find a pseudo-peripheral root (fnroot), then
    Cuthill-McKee with children sorted stably by increasing degree, and
    reverse. `adj` = sorted neighbour lists WITHOUT self-loops."""
    n = len(adj)
    mask = [1] * n
    deg = [len(a) for a in adj]

    def rootls(root):
        levels = [[root]]
        seen = {root}
        while True:
            nxt = []
            for node in levels[-1]:
                for nb in adj[node]:
                    if mask[nb] and nb not in seen:
                        seen.add(nb)
                        nxt.append(nb)
            if not nxt:
                return levels
            levels.append(nxt)

    def fnroot(root):
        levels = rootls(root)
        ccsize = sum(len(l) for l in levels)
        while True:
            nlvl = len(levels)
            if nlvl == 1 or nlvl == ccsize:
                return root
            # min-degree node of the last level, first wins (fnroot.f:300)
            mindeg = ccsize
            root = levels[-1][0]
            for node in levels[-1]:
                ndeg = sum(1 for nb in adj[node] if mask[nb])
                if ndeg < mindeg:
                    root, mindeg = node, ndeg
            newlevels = rootls(root)
            if len(newlevels) <= nlvl:
                return root
            levels = newlevels
            if len(levels) >= ccsize:
                return root

    perm = []
    for i in range(n):
        if not mask[i]:
            continue
        root = fnroot(i)
        mask[root] = 0
        ls = [root]
        k = 0
        while k < len(ls):
            fresh = [nb for nb in adj[ls[k]] if mask[nb]]
            for nb in fresh:
                mask[nb] = 0
            fresh.sort(key=lambda x: deg[x])    # stable, like rcm.f:300-500
            ls.extend(fresh)
            k += 1
        perm.extend(reversed(ls))
    return perm


def hybrid_line_ordering(md: MeshData, anisotropy_threshold: float = 10.0,
                         graph_ordering: str = "rcm") -> np.ndarray:
    """getHybridLineOrdering (meshordering.cpp:68-130): collapse lines and
    remaining cells ('points') to a graph, order the graph (natural or
    RCM), and expand back to a cell permutation."""
    lines, celline = find_lines(md, anisotropy_threshold)
    nlines = len(lines)
    points = [c for c in range(md.nelem) if celline[c] == -1]
    pt_index = {c: i for i, c in enumerate(points)}
    topo = build_topology(md)
    nfael = np.asarray(topo.nfael)

    def vert_of(cell):
        li = celline[cell]
        return int(li) if li >= 0 else nlines + pt_index[cell]

    nv = nlines + len(points)
    adjset = [set() for _ in range(nv)]
    for v in range(nv):
        cells = lines[v] if v < nlines else [points[v - nlines]]
        for cell in cells:
            for k in range(nfael[cell]):
                nb = topo.esuel[cell, k]
                if 0 <= nb < md.nelem:
                    w = vert_of(int(nb))
                    if w != v:
                        adjset[v].add(w)
                        adjset[w].add(v)
    adj = [sorted(s) for s in adjset]

    if graph_ordering == "natural":
        gperm = list(range(nv))
    elif graph_ordering == "rcm":
        gperm = _genrcm(adj)
    else:
        raise ValueError(f"unknown graph ordering '{graph_ordering}'")

    order = []
    for v in gperm:
        if v < nlines:
            order.extend(lines[v])
        else:
            order.append(points[v - nlines])
    return np.asarray(order, dtype=np.int64)


ORDERINGS = {"rcm": rcm_ordering, "line": line_ordering}


def apply_ordering(md: MeshData, name: str,
                   anisotropy_threshold: float = 10.0) -> MeshData:
    """-mesh_reorder equivalent (ameshutils.cpp:43-93): 'line' runs
    lineReorder; 'line_<X>' runs the hybrid line/point-graph ordering with
    graph ordering X; anything else is a plain cell ordering."""
    if name in (None, "", "none", "natural"):
        return md
    if name == "line":
        return reorder_mesh(md, line_ordering(md, anisotropy_threshold))
    if name.startswith("line_"):
        return reorder_mesh(md, hybrid_line_ordering(
            md, anisotropy_threshold, graph_ordering=name.split("_", 1)[1]))
    return reorder_mesh(md, ORDERINGS[name](md))
