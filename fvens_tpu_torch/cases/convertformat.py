"""Mesh format converter CLI: Gmsh2/SU2 -> VTU or Gmsh2.

Equivalent of the reference's convertformat executable
(FVENS src/utilities/convertformat.cpp:9-33); a copy of the JAX package's
cases/convertformat.py.

Usage: python -m fvens_tpu_torch.cases.convertformat in.msh out.vtu
       python -m fvens_tpu_torch.cases.convertformat in.su2 out.msh
"""

from __future__ import annotations

import sys

import numpy as np

from ..io_config.vtu import write_vtu
from ..mesh.reader import MeshData, read_mesh


def write_gmsh2(path: str, md: MeshData) -> None:
    """Gmsh 2.0 ASCII writer (reference UMesh::writeGmsh2, mesh.cpp:205-283)."""
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n")
        f.write(f"{md.npoin}\n")
        for i, (x, y) in enumerate(md.coords):
            f.write(f"{i + 1} {x:.16g} {y:.16g} 0\n")
        f.write("$EndNodes\n$Elements\n")
        f.write(f"{md.nbface + md.nelem}\n")
        eid = 1
        for ib in range(md.nbface):
            tags = " ".join(str(t) for t in md.bface[ib, 2:])
            ntags = md.bface.shape[1] - 2
            n0, n1 = md.bface[ib, 0] + 1, md.bface[ib, 1] + 1
            f.write(f"{eid} 1 {ntags} {tags} {n0} {n1}\n")
            eid += 1
        for ie in range(md.nelem):
            nn = int(md.nnode[ie])
            etype = 2 if nn == 3 else 3
            nodes = " ".join(str(int(x) + 1) for x in md.inpoel[ie, :nn])
            f.write(f"{eid} {etype} 2 0 0 {nodes}\n")
            eid += 1
        f.write("$EndElements\n")


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 2:
        print(__doc__)
        return 2
    src, dst = args
    md = read_mesh(src)
    if dst.endswith(".vtu"):
        write_vtu(dst, md)
    elif dst.endswith(".msh"):
        write_gmsh2(dst, md)
    else:
        print(f"unsupported output format: {dst}")
        return 2
    print(f"wrote {dst}: {md.nelem} cells, {md.npoin} points, "
          f"{md.nbface} boundary faces")
    return 0


if __name__ == "__main__":
    sys.exit(main())
