"""fvens_tpu_torch: the PyTorch and CUDA port of the finite-volume solver for
the 2D compressible Euler and Navier-Stokes equations.

The JAX package beside it stays the reference; this package keeps its
module tree and names, so each counterpart sits at the same path. It imports
torch and numpy only. Every function takes its tensors' device and dtype
from its inputs or from explicit `device`/`dtype` arguments; nothing here
sets a global default device or dtype.

  - the mesh is compiled once on the host (NumPy) into padded SoA tensors
  - the residual is a gather -> pointwise flux -> per-cell gather-sum
  - the first-order Jacobian is torch.func.vmap(torch.func.jacfwd(...))
  - FGMRES with banded block-Jacobi sweeps; on a CUDA card the banded
    block apply is a hand-written kernel (csrc/banded_apply.cu)
  - from 262,144 vector elements GMRES runs blocked, and each basis append
    is a hand-written kernel too (csrc/row_set.cu)
"""

NDIM = 2
NVARS = 4

__version__ = "0.1.0"
