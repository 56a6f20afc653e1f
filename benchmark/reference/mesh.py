"""The benchmark's meshes: structured quad O-meshes generated from their
formulas, handed alike to the program and to the plain reference.

FVENS's own meshes (testcases/2dcylinder/grids, testcases/naca0012/grids)
are Gmsh outputs that are not in the repository, so the benchmark
generates algebraic O-meshes of the same families:

  - cylinder_omesh: nt cells around a unit cylinder, nr cells out to a
    far field of radius 20, geometrically stretched; `turn` starts the
    numbering around at the turn-th node, so that the mesh and its
    numbering are turned together by whole cells;
  - naca0012_omesh: nt cells around a NACA0012 (closed trailing edge,
    cosine clustering, half-thickness floored at 2.5e-4), nr cells out to
    a circle of radius 20 centred at the quarter chord.

Cells are counter-clockwise quads, numbered i * nr + j (i around, j
outward); boundary faces are listed per i, the wall face (marker 2) then
the far-field face (marker 4).
"""

from __future__ import annotations

import dataclasses

import numpy as np

WALL, FAR = 2, 4


@dataclasses.dataclass
class RawMesh:
    coords: np.ndarray     # (npoin, 2) float64
    cells: np.ndarray      # (nelem, 4) int64 node ids, counter-clockwise
    bfaces: np.ndarray     # (nbface, 2) int64 node ids
    btags: np.ndarray      # (nbface,) int64 markers

    @property
    def nelem(self) -> int:
        return self.cells.shape[0]


def _omesh(X: np.ndarray, Y: np.ndarray) -> RawMesh:
    """Quads of an O-grid whose node arrays X, Y are (nt, nr + 1), i
    wrapping around."""
    nt, nr = X.shape[0], X.shape[1] - 1
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    def nid(i, j):
        return (i % nt) * (nr + 1) + j

    i, j = np.meshgrid(np.arange(nt), np.arange(nr), indexing="ij")
    i, j = i.ravel(), j.ravel()
    quad = np.stack([nid(i, j), nid(i + 1, j), nid(i + 1, j + 1),
                     nid(i, j + 1)], axis=1).astype(np.int64)
    p = coords[quad]
    s = np.zeros(len(quad))
    for k in range(4):
        q = p[:, (k + 1) % 4]
        s += p[:, k, 0] * q[:, 1] - q[:, 0] * p[:, k, 1]
    quad = np.where((s > 0)[:, None], quad, quad[:, ::-1])

    it = np.arange(nt)
    wall = np.stack([nid(it, 0), nid(it + 1, 0)], axis=1)
    far = np.stack([nid(it + 1, nr), nid(it, nr)], axis=1)
    bfaces = np.stack([wall, far], axis=1).reshape(-1, 2).astype(np.int64)
    btags = np.tile(np.array([WALL, FAR], np.int64), nt)
    return RawMesh(coords, quad, bfaces, btags)


def cylinder_omesh(nt: int, nr: int, stretch: float, r_in: float = 1.0,
                   r_out: float = 20.0, turn: int = 0) -> RawMesh:
    theta = np.roll(np.linspace(0.0, 2.0 * np.pi, nt + 1)[:-1], -turn)
    if abs(stretch - 1.0) < 1e-12:
        t = np.linspace(0, 1, nr + 1)
    else:
        w = stretch ** np.arange(nr)
        t = np.concatenate([[0.0], np.cumsum(w)])
        t /= t[-1]
    r = r_in + (r_out - r_in) * t
    R, TH = np.meshgrid(r, theta, indexing="ij")
    return _omesh((R * np.cos(TH)).T, (R * np.sin(TH)).T)


def _radial_distribution(nr: int, first_frac: float) -> np.ndarray:
    if first_frac * nr >= 1.0:
        return np.linspace(0.0, 1.0, nr + 1)
    lo, hi = 1.0 + 1e-12, 4.0
    for _ in range(80):
        r = 0.5 * (lo + hi)
        if first_frac * (r ** nr - 1.0) / (r - 1.0) < 1.0:
            lo = r
        else:
            hi = r
    w = first_frac * lo ** np.arange(nr)
    t = np.concatenate([[0.0], np.cumsum(w)])
    return t / t[-1]


def naca0012_omesh(nt: int, nr: int, r_out: float = 20.0,
                   first_layer: float = 2e-4) -> RawMesh:
    beta = np.linspace(0.0, 2.0 * np.pi, nt + 1)[:-1]
    xc = 0.5 * (1.0 + np.cos(beta))
    th = 0.12
    yt = 5 * th * (0.2969 * np.sqrt(xc) - 0.1260 * xc - 0.3516 * xc ** 2
                   + 0.2843 * xc ** 3 - 0.1036 * xc ** 4)
    yt = np.maximum(yt, 2.5e-4)
    ysurf = np.where(beta <= np.pi, yt, -yt)
    x1 = 0.25 + r_out * np.cos(beta)
    y1 = r_out * np.sin(beta)
    tt = _radial_distribution(nr, first_layer)
    X = xc[:, None] + (x1 - xc)[:, None] * tt[None, :]
    Y = ysurf[:, None] + (y1 - ysurf)[:, None] * tt[None, :]
    return _omesh(X, Y)


GENERATORS = {"cylinder_omesh": cylinder_omesh,
              "naca0012_omesh": naca0012_omesh}


def make_mesh(spec: dict) -> RawMesh:
    """The mesh a configuration file names: {"generator": name, **args};
    a "stretch" given as [base, exponent] is base ** exponent."""
    kw = {k: v for k, v in spec.items() if k != "generator"}
    if isinstance(kw.get("stretch"), list):
        base, exp = kw["stretch"]
        kw["stretch"] = float(base) ** float(exp)
    return GENERATORS[spec["generator"]](**kw)
