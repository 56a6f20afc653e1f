"""Meshes and seeded block Jacobians for the slot kernel's tests
(test_torch_slot_kernel.py on the CPU, test_torch_slot_kernel_gpu.py on
the card). Imports no JAX."""

import numpy as np
import torch

from fvens_tpu_torch.config import BCSpec
from fvens_tpu_torch.mesh import meshgen
from fvens_tpu_torch.mesh.device_mesh import compile_mesh
from fvens_tpu_torch.mesh.reader import _assemble
from fvens_tpu_torch.solver.linear import BlockJacobian


def hybrid_square(n: int):
    """An n x n unit square of quadrilaterals in its first half and of
    triangles (each quad split in two) in its second, so cells of three and
    of four faces lie side by side: a triangle's fourth slot and every
    boundary slot point past the real cells and are clamped."""
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    def nid(i, j):
        return i * (n + 1) + j
    cells = []
    for i in range(n):
        for j in range(n):
            q = [nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)]
            if i < n // 2:
                cells.append((q, []))
            else:
                cells += [([q[0], q[1], q[2]], []), ([q[0], q[2], q[3]], [])]
    bfaces = []
    for k in range(n):
        bfaces += [([nid(0, k + 1), nid(0, k)], [1]),
                   ([nid(n, k), nid(n, k + 1)], [1]),
                   ([nid(k, 0), nid(k + 1, 0)], [1]),
                   ([nid(k + 1, n), nid(k, n)], [1])]
    return _assemble(coords, cells, bfaces, nbtag=1, ndtag=0)


# name: (MeshData factory, BCs)
MESHES = {
    "hybrid_square(9)": (lambda: hybrid_square(9),
                         [BCSpec(marker=1, type="farfield")]),
    "naca0012_omesh(64, 16)": (lambda: meshgen.naca0012_omesh(64, 16),
                               [BCSpec(marker=2, type="slipwall"),
                                BCSpec(marker=4, type="farfield")]),
}


def mesh(name: str, device):
    make, bcs = MESHES[name]
    return compile_mesh(make(), bcs, dtype=torch.float64, device=device)


def jacobian(m, V: int, dtype, seed: int = 0) -> BlockJacobian:
    """A seeded block Jacobian in slot form on mesh m: diagonally dominant
    D, and N zero on the slots without a real neighbour, as
    assemble_jacobian makes it (the clamped gathers rely on that)."""
    g = np.random.default_rng(seed)
    NC = m.NC
    D = 4.0 * np.eye(V) + 0.5 * g.standard_normal((NC, V, V))
    N = 0.3 * g.standard_normal((NC, 4, V, V))
    N *= m.nbr_mask.cpu().numpy()[:, :, None, None]
    return BlockJacobian(torch.from_numpy(D).to(m.cell_nbrs.device, dtype),
                         torch.from_numpy(N).to(m.cell_nbrs.device, dtype))
