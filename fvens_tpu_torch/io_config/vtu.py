"""VTK unstructured-grid (.vtu XML) writer for cell and point data.

Equivalent of the reference's VTU output (FVENS src/spatial/aoutput.cpp:
301-616): writes the hybrid tri/quad mesh with named scalar/vector fields.
"""

from __future__ import annotations

import numpy as np

_VTK_TRI = 5
_VTK_QUAD = 9


def write_vtu(path: str, md, cell_scalars: dict | None = None,
              cell_vectors: dict | None = None,
              point_scalars: dict | None = None) -> None:
    """md: MeshData (host). Field arrays sized (nelem,) / (nelem,2) /
    (npoin,)."""
    coords = md.coords
    npoin = md.npoin
    nelem = md.nelem

    conn = []
    offsets = []
    types = []
    off = 0
    for ie in range(nelem):
        nn = int(md.nnode[ie])
        conn.extend(int(x) for x in md.inpoel[ie, :nn])
        off += nn
        offsets.append(off)
        types.append(_VTK_TRI if nn == 3 else _VTK_QUAD)

    def arr2txt(a, fmt="%.16g"):
        a = np.asarray(a)
        return " ".join(fmt % x for x in a.ravel())

    lines = []
    w = lines.append
    w('<?xml version="1.0"?>')
    w('<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">')
    w('  <UnstructuredGrid>')
    w(f'    <Piece NumberOfPoints="{npoin}" NumberOfCells="{nelem}">')

    if point_scalars:
        w('      <PointData>')
        for name, data in point_scalars.items():
            w(f'        <DataArray type="Float64" Name="{name}" format="ascii">')
            w('          ' + arr2txt(data))
            w('        </DataArray>')
        w('      </PointData>')

    if cell_scalars or cell_vectors:
        w('      <CellData>')
        for name, data in (cell_scalars or {}).items():
            w(f'        <DataArray type="Float64" Name="{name}" format="ascii">')
            w('          ' + arr2txt(data))
            w('        </DataArray>')
        for name, data in (cell_vectors or {}).items():
            d = np.asarray(data)
            d3 = np.concatenate([d, np.zeros((d.shape[0], 1))], axis=1)
            w(f'        <DataArray type="Float64" Name="{name}" '
              f'NumberOfComponents="3" format="ascii">')
            w('          ' + arr2txt(d3))
            w('        </DataArray>')
        w('      </CellData>')

    w('      <Points>')
    w('        <DataArray type="Float64" NumberOfComponents="3" format="ascii">')
    c3 = np.concatenate([coords, np.zeros((npoin, 1))], axis=1)
    w('          ' + arr2txt(c3))
    w('        </DataArray>')
    w('      </Points>')
    w('      <Cells>')
    w('        <DataArray type="Int64" Name="connectivity" format="ascii">')
    w('          ' + " ".join(str(x) for x in conn))
    w('        </DataArray>')
    w('        <DataArray type="Int64" Name="offsets" format="ascii">')
    w('          ' + " ".join(str(x) for x in offsets))
    w('        </DataArray>')
    w('        <DataArray type="UInt8" Name="types" format="ascii">')
    w('          ' + " ".join(str(x) for x in types))
    w('        </DataArray>')
    w('      </Cells>')
    w('    </Piece>')
    w('  </UnstructuredGrid>')
    w('</VTKFile>')
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
