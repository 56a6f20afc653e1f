"""Block ILU(0) preconditioner in fixed-point (Chow-Patel) form, the JAX
package's solver/ilu.py in PyTorch.

The reference's default preconditioner is bjacobi+ILU0 via BLASTed
(testcases/defaults.solverc:16-19, src/linalg/alinalg.cpp:301-384), whose
async-sweep variant computes the incomplete factors by parallel
fixed-point sweeps instead of the sequential IKJ loop (Chow & Patel,
"Fine-grained parallel incomplete LU factorization", SISC 2015):

  - factorization: every block-nonzero's ILU0 equation
        L_ij = (A_ij - sum_{k<j} L_ik U_kj) U_jj^{-1}      (i > j)
        U_ij =  A_ij - sum_{k<i} L_ik U_kj                 (i <= j)
    is updated simultaneously from the previous iterate: slot gathers and
    batched 4x4 products, no ordering, no levels;
  - application: the triangular solves are truncated Neumann/Jacobi
    iterations,
        y^{t+1} = v - L y^t,       z^{t+1} = Ud^{-1} (y - Us z^t),
    again slot gathers and batched products.

The sparsity bookkeeping (ILUStructure) is computed once per mesh on the
host in NumPy and kept as tensors on the mesh's device; the factorization
runs once per Newton step on the device, at the Krylov precision.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .linear import (_gather_rows, _nbrs_in_range, _row_elements,
                     _slot_apply, _slot_operand, block_jacobi_inverse)


class ILUStructure(NamedTuple):
    """Static (per-mesh) slot bookkeeping for the fixed-point block ILU0."""
    rs: torch.Tensor         # (NC,K) int64: slot in row nbr(c,k) pointing
    #                          back at c (the (nbr,c) block's storage slot)
    lower: torch.Tensor      # (NC,K) 1.0 where nbr(c,k) < c (valid slots)
    upper: torch.Tensor      # (NC,K) 1.0 where nbr(c,k) > c (valid slots)
    fill_sb: torch.Tensor    # (NC,K,K) int64: for target slot s of row c and
    #                          source slot a (k = nbr(c,a)): the slot of row
    #                          k holding the (k, nbr(c,s)) block
    fill_mask: torch.Tensor  # (NC,K,K) 1.0 where the ILU0 correction term
    #                          L_ck U_kj (k < min(c, j), k in nbr(c) &
    #                          nbr(j)) exists


def ilu_structure(mesh) -> ILUStructure:
    """Host-side sparsity analysis (cached per mesh by the solver), as
    tensors on the mesh's device."""
    nbrs = mesh.cell_nbrs.cpu().numpy()
    mask = mesh.nbr_mask.cpu().numpy() > 0
    NC, K = nbrs.shape
    cells = np.arange(NC)
    safe = np.clip(nbrs, 0, NC - 1)

    # reverse slots: nbrs[nbr(c,k)] == c
    nn = nbrs[safe]                                   # (NC,K,K)
    eq = nn == cells[:, None, None]
    rs = eq.argmax(axis=2)

    j = nbrs
    lower = mask & (j < cells[:, None])
    upper = mask & (j > cells[:, None])

    # fill terms for off-diagonal slot (c,s) -> j: source slot a with
    # k = nbr(c,a), k < min(c,j), and j in nbr(k) at slot sb
    eq2 = nn[:, None, :, :] == j[:, :, None, None]    # (NC,s,a,sb)
    sb = eq2.argmax(axis=3)                           # (NC,K,K)
    has = eq2.any(axis=3)
    kmat = np.broadcast_to(nbrs[:, None, :], (NC, K, K))
    jmat = np.broadcast_to(j[:, :, None], (NC, K, K))
    fmask = (has
             & np.broadcast_to(mask[:, None, :], (NC, K, K))   # (c,a) valid
             & np.broadcast_to(mask[:, :, None], (NC, K, K))   # (c,s) valid
             & (kmat < np.minimum(cells[:, None, None], jmat)))

    dev = mesh.cell_nbrs.device

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)
    return ILUStructure(rs=t(rs, torch.int64),
                        lower=t(lower, torch.float32),
                        upper=t(upper, torch.float32),
                        fill_sb=t(sb, torch.int64),
                        fill_mask=t(fmask, torch.float32))


def ilu_factorize(mesh, jac, st: ILUStructure, sweeps: int = 4):
    """Fixed-point block-ILU0 factorization (device, per Newton step).

    Returns (L, Ud, Udinv, Us): strictly-lower blocks of the unit-lower
    factor (slot layout, zero off-pattern), the upper factor's diagonal
    blocks, their inverses, and the strictly-upper blocks. With sweeps >=
    the factorization's dependency depth the result is the exact ILU0
    factors; fewer sweeps give the Chow-Patel approximation."""
    nbrs = _nbrs_in_range(mesh)
    D, N = jac.D, jac.N
    dt = D.dtype
    lm = st.lower.to(dt)[..., None, None]              # (NC,K,1,1)
    um = st.upper.to(dt)[..., None, None]
    fm = st.fill_mask.to(dt)[..., None, None]          # (NC,K,K,1,1)
    kk = nbrs[:, None, :].expand(st.fill_sb.shape)     # (NC,s,a)

    Ud = D
    Udinv = block_jacobi_inverse(Ud)
    Us = N * um
    L = torch.einsum("caij,cajl->cail", N * lm, Udinv[nbrs])

    for _ in range(sweeps):
        # the (k, j) block with k < j lives in Us; the sb slot indexing is
        # built only over off-diagonal targets, so Us suffices
        Ukj = Us[kk, st.fill_sb] * fm                  # (NC,s,a,V,V)
        corr = torch.einsum("caij,csajl->csil", L, Ukj)
        S = N - corr                                   # (NC,K,V,V)

        # diagonal: Ud_c = D_c - sum_{a: nbr<c} L_ca U_{nbr(c,a), c}
        Urev = Us[nbrs, st.rs] * lm                    # (NC,K,V,V)
        Ud = D - torch.einsum("caij,cajl->cil", L, Urev)
        Udinv = block_jacobi_inverse(Ud)

        Us = S * um
        L = torch.einsum("caij,cajl->cail", S * lm, Udinv[nbrs])

    return L, Ud, Udinv, Us


def make_ilu_apply(mesh, L, Udinv, Us, sweeps: int = 3):
    """pc(v) ~= (L U)^{-1} v with truncated-Neumann triangular solves.

    Lower solve (unit-lower): y <- v - L y, `sweeps` times (y0 = v).
    Upper solve:              z <- Udinv (y - Us z), `sweeps` times
    (z0 = Udinv y). Each sweep is one (NC,K) neighbour-row gather and one
    batched block product, the shape of a bsgs sweep; the slot operands
    are built here, once per Newton step."""
    nbrs = _nbrs_in_range(mesh)
    elems = _row_elements(nbrs, Udinv.shape[-1])
    Lop, Uop = _slot_operand(L), _slot_operand(Us)

    def pc(v):
        y = v
        for _ in range(sweeps):
            y = v - _slot_apply(Lop, _gather_rows(y, elems, nbrs.shape))
        z = torch.einsum("cij,cj->ci", Udinv, y)
        for _ in range(sweeps):
            z = torch.einsum("cij,cj->ci", Udinv, y - _slot_apply(
                Uop, _gather_rows(z, elems, nbrs.shape)))
        return z

    return pc
