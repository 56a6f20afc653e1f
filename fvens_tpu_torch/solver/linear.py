"""Linear solver stack of the main path: slot-block Jacobian operators, the
block preconditioners and a restarted flexible GMRES.

Replaces PETSc (MPIBAIJ + FGMRES(30) + bjacobi/ILU0, FVENS
src/linalg/alinalg.cpp + testcases/defaults.solverc). The vectors, the
Arnoldi basis and every matvec/preconditioner apply stay on the device; the
O(m) Givens/Hessenberg scalar work runs on the host in NumPy at the Krylov
dtype, fed by ONE device->host copy per iteration (the copy that the
convergence test needs anyway).

GMRES has both of the JAX package's paths: the classic CGS2 one and, from
262,144 vector elements, the blocked low-traffic one, whose basis appends
are the CUDA kernel of solver/rowset_kernels.py. The gather path's
operators are plain PyTorch: the slot matvec and the none / bjacobi / bsgs
/ bcsgs preconditioners (make_preconditioner); ilu0, bline and amg are
still to be ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .rowset_kernels import row_set


class BlockJacobian(NamedTuple):
    """First-order Jacobian of r(u) = -rhs(u) in per-cell-slot block form
    (the layout the matvec and the sweeps consume directly):

        (J x)_c = D_c x_c + sum_k N_ck x_nbr(c,k)

    D folds the boundary-ghost contribution (the reference's
    `left = len*(L - R*drdl)` fold, flow_spatial.cpp:841-875, comes free
    from differentiating through the BC composition in assemble_jacobian).
    """
    D: torch.Tensor   # (NC,V,V) diagonal blocks (incl. pseudo-time term)
    N: torch.Tensor   # (NC,4,V,V) per-slot neighbour blocks (0 at boundaries)


def _nbrs_in_range(mesh):
    """Neighbour indices clamped into [0, NC): boundary/ghost slots point at
    an arbitrary real row, which is safe wherever the gathered value is
    multiplied by the neighbour blocks N (zero on exactly those slots)."""
    return torch.clamp_max(mesh.cell_nbrs, mesh.NC - 1)


def _row_elements(idx, V: int):
    """The flat element indices of rows `idx` of a contiguous (n, V)
    tensor, for _gather_rows. Built once per Newton step."""
    cols = torch.arange(V, dtype=idx.dtype, device=idx.device)
    return (idx.reshape(-1, 1) * V + cols).reshape(-1)


def _gather_rows(x, elems, shape):
    """x[idx] for a contiguous (n, V) x, with elems = _row_elements(idx, V)
    and idx of `shape`: the same values, gathered element by element from
    the flat tensor. On CUDA PyTorch gathers 16-byte rows (x[idx],
    index_select of rows) with its vectorized gather kernel, one 32-thread
    block per index: 0.62 ms for the (NC, 5) gather of the 640x320 matvec
    on an H100, against 0.024 ms element by element, as fast as torch.take
    (PERF.md section 5; profile_step --case slot-gather). On the CPU
    torch.take can hand even a few thousand elements to the thread pool;
    index_select does not."""
    return x.reshape(-1).index_select(0, elems).reshape(*shape, x.shape[1])


def _slot_operand(blocks):
    """(R,S,V,V) per-slot blocks as the (R,V,S*V) operand of _slot_apply:
    row i of a cell's blocks side by side, slot by slot. Built once per
    Newton step, so that a slot contraction is one batched product and not
    a permuted copy of the blocks on every call."""
    R, S, V, _ = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(R, V, S * V)


def _slot_apply(op, xg):
    """sum_k B_k x_k per row: op (R,V,S*V) from _slot_operand, xg (R,S,V)
    the gathered slot vectors; the contraction einsum("rkij,rkj->ri")
    makes, as one batched product."""
    R, S, V = xg.shape
    return torch.bmm(op, xg.reshape(R, S * V, 1)).reshape(R, V)


def make_bsr_matvec(mesh, jac: BlockJacobian) -> Callable:
    """Returns mv(x) = J x as one (NC,5) row gather + one batched block
    contraction: the diagonal joins the neighbour slots as a fifth
    self-pointing slot. The fused (NC,5,V,V) operand is built here, ONCE per
    Jacobian — call this outside the Krylov loop."""
    NC = jac.D.shape[0]
    self_idx = torch.arange(NC, dtype=mesh.cell_nbrs.dtype,
                            device=jac.D.device)
    idx = torch.cat([self_idx[:, None], _nbrs_in_range(mesh)], dim=1)
    elems = _row_elements(idx, jac.D.shape[-1])
    op = _slot_operand(torch.cat([jac.D[:, None], jac.N], dim=1))

    def mv(x):
        return _slot_apply(op, _gather_rows(x, elems, idx.shape))

    return mv


PRECONDITIONERS = ("none", "bjacobi", "bsgs", "bcsgs")
UNPORTED_PRECONDITIONERS = ("ilu0", "bline", "amg")


def make_preconditioner(mesh, jac: BlockJacobian, kind: str = "bjacobi",
                        sweeps: int = 4) -> Callable:
    """Returns pc(v) ~= J^-1 v on the gather path, as the JAX package's
    make_preconditioner:

      - none: v;
      - bjacobi: z = D^-1 v;
      - bsgs: `sweeps` block-Jacobi sweeps z' = D^-1 v - (D^-1 N) z_nbr
        from z = D^-1 v, each one (NC,4) slot gather and one batched block
        product;
      - bcsgs: multicolor block SGS (make_colored_sgs), `sweeps` forward and
        backward color passes.

    ilu0, bline and amg are not ported yet (ROADMAP queue 1 item 8) and
    raise NotImplementedError; any other name raises ValueError."""
    if kind == "none":
        return lambda v: v
    if kind in UNPORTED_PRECONDITIONERS:
        raise NotImplementedError(f"not ported yet: pc='{kind}' (ROADMAP "
                                  "queue 1 item 8)")
    if kind not in PRECONDITIONERS:
        raise ValueError(f"unknown preconditioner '{kind}'")
    Dinv = block_jacobi_inverse(jac.D)
    apply_dinv = lambda v: torch.einsum("cij,cj->ci", Dinv, v)
    if kind == "bjacobi":
        return apply_dinv
    if kind == "bcsgs":
        return make_colored_sgs(mesh, jac, Dinv, jac.N, sweeps)
    # the defect-correction sweep z + D^-1(v - J z) reduces exactly to
    # block-Jacobi z' = D^-1 v - (D^-1 N) z_nbr (J = D + N)
    DN = _slot_operand(torch.einsum("cij,ckjl->ckil", Dinv, jac.N))
    nbrs = _nbrs_in_range(mesh)
    elems = _row_elements(nbrs, jac.D.shape[-1])

    def pc(v):
        dv = apply_dinv(v)
        z = dv
        for _ in range(sweeps):
            z = dv - _slot_apply(DN, _gather_rows(z, elems, nbrs.shape))
        return z
    return pc


def make_colored_sgs(mesh, jac: BlockJacobian, Dinv, blocks,
                     sweeps: int = 1) -> Callable:
    """Multicolor block symmetric Gauss-Seidel, the JAX package's
    make_colored_sgs: cells of one adjacency color share no faces, so each
    color updates as one batched block step with the freshest neighbour
    values. One sweep = forward + backward color passes.

    The per-color gathers and the D^-1 folding (z_c = (D^-1 v)_c -
    sum_k (D^-1 N)_ck z_nbr) are precomputed once per Newton step, so one
    color update is one row gather of z, one batched block product and one
    row scatter (index_copy_ into z, which pc owns).

    Colors differ in size, and mesh.color_rows pads the shorter ones with
    NC-1 (greedy_coloring). When n_cells is a multiple of 8, NC-1 is a real
    cell, and a padded slot updates it in a color it does not belong to,
    as in the JAX package, whose scatter this reproduces unmasked. The
    duplicate rows of one color compute the same value from the same
    inputs, so the order in which index_copy_ writes them (undefined on
    CUDA) does not change the result."""
    rows_all = mesh.color_rows                       # (ncol, R)
    ncol = mesh.n_colors
    nbrs_in = _nbrs_in_range(mesh)
    V = Dinv.shape[-1]
    rows = [rows_all[c] for c in range(ncol)]
    row_elems = [_row_elements(r, V) for r in rows]
    col_nbrs = [nbrs_in[r] for r in rows]
    col_elems = [_row_elements(n, V) for n in col_nbrs]
    col_DN = [_slot_operand(torch.einsum("rij,rkjl->rkil", Dinv[r],
                                         blocks[r])) for r in rows]
    order = list(range(ncol)) + list(range(ncol - 1, -1, -1))

    def pc(v):
        dv = torch.einsum("cij,cj->ci", Dinv, v)     # one whole-mesh solve
        col_dv = [_gather_rows(dv, e, r.shape)
                  for e, r in zip(row_elems, rows)]
        z = torch.zeros_like(v)
        for _ in range(sweeps):
            for c in order:                          # forward, backward
                zn = _gather_rows(z, col_elems[c], col_nbrs[c].shape)
                z.index_copy_(0, rows[c], col_dv[c]
                              - _slot_apply(col_DN[c], zn))
        return z

    return pc


def block_jacobi_inverse(D):
    """Batched small-matrix inverses for the block-Jacobi preconditioner, by
    closed-form adjugate (n <= 4), the same arithmetic as the JAX package."""
    n = D.shape[-1]
    if n == 1:
        return 1.0 / D
    if n == 2:
        a, b = D[..., 0, 0], D[..., 0, 1]
        c, d = D[..., 1, 0], D[..., 1, 1]
        det = a * d - b * c
        inv = torch.stack([torch.stack([d, -b], -1),
                           torch.stack([-c, a], -1)], -2)
        return inv / det[..., None, None]
    if n == 4:
        return _inv4(D)
    raise NotImplementedError(f"block size {n}")


def _inv4(M):
    """Batched explicit 4x4 inverse by cofactor expansion."""
    m = [[M[..., i, j] for j in range(4)] for i in range(4)]

    def det3(r, c):
        rows = [i for i in range(4) if i != r]
        cols = [j for j in range(4) if j != c]
        a, b, cc = rows
        p, q, s = cols
        return (m[a][p] * (m[b][q] * m[cc][s] - m[b][s] * m[cc][q])
                - m[a][q] * (m[b][p] * m[cc][s] - m[b][s] * m[cc][p])
                + m[a][s] * (m[b][p] * m[cc][q] - m[b][q] * m[cc][p]))

    cof = [[((-1.0) ** (i + j)) * det3(i, j) for j in range(4)]
           for i in range(4)]
    det = sum(m[0][j] * cof[0][j] for j in range(4))
    # adjugate = transpose of cofactor matrix
    adj = torch.stack([torch.stack([cof[j][i] for j in range(4)], dim=-1)
                       for i in range(4)], dim=-2)
    return adj / det[..., None, None]


def _norm2(v):
    """sqrt(sum v^2) on the device, the JAX package's norm arithmetic."""
    return torch.sqrt(torch.sum(v * v))


# Above this many vector elements gmres runs the blocked path by itself, as
# the JAX package does; below it the classic CGS2 path stays bit-identical.
# Read at call time, so a test can lower it.
_BLOCKED_N_THRESHOLD = 262_144
_ROW_BLOCK = 8           # the JAX package's MGS block height (its arithmetic)


def _mgs_pass(V, w, rows: int):
    """One blocked modified-Gram-Schmidt pass of w against V[:rows]: each
    8-row block is projected out of w before the next is read, over the
    ceil(rows/8)*8 filled-or-zero rows only (rows past `rows`-1 are still
    zero and project nothing). Returns (h, w_new) with h (mpad,) zero
    beyond the blocks read."""
    B = _ROW_BLOCK
    h = torch.zeros(V.shape[0], dtype=w.dtype, device=w.device)
    for i in range(0, rows, B):
        Vb = V[i:i + B]
        hb = Vb @ w
        w = w - hb @ Vb
        h[i:i + B] = hb
    return h, w


def _rows_combine(M, y, rows: int):
    """x-update helper: M[:rows].T @ y, reading only the used rows."""
    return M[:rows].T @ y


def _hessenberg_column(hcol, j, cs, sn, g, tiny):
    """Apply the stored Givens rotations to the new column hcol, form the
    j-th rotation and update g, all on the host at the Krylov dtype.
    Returns |g[j+1]|, the new residual estimate."""
    for i in range(j):
        t1 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
        t2 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
        hcol[i], hcol[i + 1] = t1, t2

    denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
    with np.errstate(invalid="ignore", divide="ignore"):
        # a NaN column propagates like on the device; the caller sees a
        # non-finite relres and rejects the step
        c_new = hcol[j] / np.maximum(denom, tiny)
        s_new = hcol[j + 1] / np.maximum(denom, tiny)
    hcol[j] = denom
    hcol[j + 1] = 0.0
    cs[j] = c_new
    sn[j] = s_new
    g[j + 1] = -s_new * g[j]
    g[j] = c_new * g[j]
    return np.abs(g[j + 1])


def _least_squares(H, g, j, dev):
    """y of the upper-triangular system H[:j, :j] y = g[:j], on `dev`."""
    R = torch.from_numpy(np.ascontiguousarray(H[:j, :j]))
    rhs_t = torch.from_numpy(g[:j].copy())[:, None]
    return torch.linalg.solve_triangular(R, rhs_t, upper=True)[:, 0].to(dev)


def gmres(matvec: Callable, b, x0, pc: Callable, restart: int = 30,
          maxiter: int = 30, rtol: float = 1e-1, blocked: bool | None = None):
    """Right-preconditioned restarted flexible GMRES on (NC,V)-shaped
    vectors. Matches the reference's Krylov settings (FGMRES,
    alinalg.cpp). Returns (x, iterations, relres) with iterations a Python
    int and relres a NumPy scalar of the Krylov dtype.

    Two paths, as in the JAX package; `blocked=None` takes the blocked one
    once a vector has at least _BLOCKED_N_THRESHOLD elements:
      - classic: two dense classical Gram-Schmidt passes per iteration over
        the filled basis rows, and stored preconditioned directions Z, so
        iteration-dependent preconditioners stay legal;
      - blocked: one blocked-MGS pass (_mgs_pass), a second only when it
        removed more than 30% of w's norm (wn1 < 0.7 wn0), and no Z store:
        the preconditioners of this package are fixed linear operators per
        step, so x += pc(V[:j]^T y) costs one trailing pc apply instead of
        an (m, n) store. The basis is (ceil((m+1)/8)*8, n), allocated once
        per cycle and written in place, each new row by row_set (the CUDA
        kernel of solver/rowset_kernels.py on a CUDA tensor).

    Eager-GPU design: each iteration's Hessenberg column (h and the new
    norm) comes to the host in one copy; the Givens rotations, the
    convergence test and the triangular solve run there in NumPy at the
    Krylov dtype, so the O(m) scalar work costs no kernel launches. The
    blocked path's second-pass decision fetches the two norms in one more
    copy per iteration.
    """
    if b.is_cuda:
        # the f32 Arnoldi products must run in full f32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    shape = b.shape
    n = b.numel()
    hdt = np.float32 if b.dtype == torch.float32 else np.float64
    tiny = hdt(1e-300)          # 0 in f32, as the JAX package's weak scalar
    bf = b.reshape(n)
    if blocked is None:
        blocked = n >= _BLOCKED_N_THRESHOLD

    mv = lambda v: matvec(v.reshape(shape)).reshape(n)
    pcf = lambda v: pc(v.reshape(shape)).reshape(n)

    bnorm = hdt(_norm2(bf).item())
    tol = hdt(rtol) * bnorm
    ncycles = max(1, -(-maxiter // restart))
    cycle = _cycle_blocked if blocked else _cycle_classic

    x = x0.reshape(n).clone()
    iters = 0
    res = hdt(np.inf)
    for c in range(ncycles):
        if c > 0 and not res > tol:
            break               # converged restarts skip the whole cycle
        x, j, res = cycle(mv, pcf, bf, x, restart, tol, hdt)
        iters += j
    return x.reshape(shape), iters, res / np.maximum(bnorm, tiny)


def _cycle_classic(mv, pcf, bf, x, m, tol, hdt):
    """One restart cycle of the classic CGS2 path. Returns (x, j, res)."""
    n, dtype, dev = bf.numel(), bf.dtype, bf.device
    tiny = hdt(1e-300)
    r = bf - mv(x)
    beta_d = _norm2(r)
    V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
    Z = torch.zeros((m, n), dtype=dtype, device=dev)
    V[0] = r / torch.clamp_min(beta_d, 1e-300)
    beta = hdt(beta_d.item())

    H = np.zeros((m + 1, m), hdt)
    cs = np.zeros(m, hdt)
    sn = np.zeros(m, hdt)
    g = np.zeros(m + 1, hdt)
    g[0] = beta
    j = 0
    res = beta
    while j < m and res > tol:
        z = pcf(V[j])
        w = mv(z)
        Z[j] = z

        # classical Gram-Schmidt with one re-orthogonalization pass, over
        # the j+1 filled basis rows
        Vj = V[:j + 1]
        h = Vj @ w
        w = w - Vj.T @ h
        h2 = Vj @ w
        w = w - Vj.T @ h2
        h = h + h2
        hn = _norm2(w)
        V[j + 1] = w / torch.clamp_min(hn, 1e-300)
        hcol = np.zeros(m + 1, hdt)
        hcol[:j + 2] = torch.cat([h, hn[None]]).cpu().numpy()
        res = _hessenberg_column(hcol, j, cs, sn, g, tiny)
        H[:, j] = hcol
        j += 1

    if j > 0:
        x = x + Z[:j].T @ _least_squares(H, g, j, dev)
    return x, j, res


def _cycle_blocked(mv, pcf, bf, x, m, tol, hdt):
    """One restart cycle of the blocked path. Returns (x, j, res)."""
    n, dtype, dev = bf.numel(), bf.dtype, bf.device
    tiny = hdt(1e-300)
    mpad = -(-(m + 1) // _ROW_BLOCK) * _ROW_BLOCK
    r = bf - mv(x)
    beta_d = _norm2(r)
    V = torch.zeros((mpad, n), dtype=dtype, device=dev)
    V[0] = r / torch.clamp_min(beta_d, 1e-300)
    beta = hdt(beta_d.item())

    H = np.zeros((m + 1, m), hdt)
    cs = np.zeros(m, hdt)
    sn = np.zeros(m, hdt)
    g = np.zeros(m + 1, hdt)
    g[0] = beta
    j = 0
    res = beta
    while j < m and res > tol:
        w = mv(pcf(V[j]))
        wn0 = _norm2(w)
        h, w = _mgs_pass(V, w, j + 1)
        hn = _norm2(w)
        wn = torch.stack([wn0, hn]).cpu().numpy()
        # the selective second pass, decided at the Krylov dtype
        if wn[1] < hdt(0.7) * wn[0]:
            h2, w = _mgs_pass(V, w, j + 1)
            h = h + h2
            hn = _norm2(w)
        row_set(V, j + 1, w, hn)
        hcol = np.zeros(m + 1, hdt)
        hcol[:j + 2] = torch.cat([h[:j + 1], hn[None]]).cpu().numpy()
        res = _hessenberg_column(hcol, j, cs, sn, g, tiny)
        H[:, j] = hcol
        j += 1

    if j > 0:
        x = x + pcf(_rows_combine(V, _least_squares(H, g, j, dev), j))
    return x, j, res
