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
operators are plain PyTorch: the slot matvec and every preconditioner of
make_preconditioner (none, bjacobi, bsgs, bcsgs, the fixed-point block
ILU0 of solver/ilu.py, the line smoother over solver/lines.py and the
aggregation multigrid of solver/multigrid.py). gmres_dr is the JAX
package's GCRO-DR recycling GMRES, on the classic path at every size.

gmres_device is gmres with its control on the device, the counterpart of
the JAX package's while-loop FGMRES: the same two paths, the Givens work by
the CUDA kernel of solver/givens_kernels.py, and each iteration, second
pass and restart guarded by a device predicate (computed and selected
eagerly, or an IF node of a captured CUDA graph, decided by the
compare-and-set kernel of solver/graph_if.py or, from one Krylov
iteration to the next, by the Givens update). The device-resident
stepping options run it (solver/device_stepping.py).
"""

from __future__ import annotations

import functools

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..io_config import logs
from .givens_kernels import givens_column
from .graph_if import GREATER, LESS, cond_set
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


PRECONDITIONERS = ("none", "bjacobi", "bsgs", "bcsgs", "ilu0", "bline",
                   "amg")


def make_preconditioner(mesh, jac: BlockJacobian, kind: str = "bjacobi",
                        sweeps: int = 4, lines=None, mg=None,
                        mg_opts=None, ilu=None, ilu_setup: int = 4
                        ) -> Callable:
    """Returns pc(v) ~= J^-1 v on the gather path, as the JAX package's
    make_preconditioner:

      - none: v;
      - bjacobi: z = D^-1 v;
      - bsgs: `sweeps` block-Jacobi sweeps z' = D^-1 v - (D^-1 N) z_nbr
        from z = D^-1 v, each one (NC,4) slot gather and one batched block
        product;
      - bcsgs: multicolor block SGS (make_colored_sgs), `sweeps` forward and
        backward color passes;
      - ilu0: the fixed-point block ILU0 of solver/ilu.py (`ilu` its
        ILUStructure): `ilu_setup` factorization sweeps, then `sweeps`
        truncated-Neumann sweeps per triangular solve;
      - bline: the line smoother (make_line_smoother, `lines` a
        solver/lines.py LineStructure), `sweeps` sweeps;
      - amg: the V-cycle of solver/multigrid.py (`mg` its MGHierarchy,
        `mg_opts` make_mg_preconditioner's keywords).

    Any other name raises ValueError, as does ilu0, bline or amg without
    its structure."""
    if kind == "none":
        return lambda v: v
    if kind not in PRECONDITIONERS:
        raise ValueError(f"unknown preconditioner '{kind}'")
    if kind == "ilu0":
        if ilu is None:
            raise ValueError("pc='ilu0' needs an ILUStructure")
        from .ilu import ilu_factorize, make_ilu_apply
        L, _, Udinv, Us = ilu_factorize(mesh, jac, ilu, sweeps=ilu_setup)
        return make_ilu_apply(mesh, L, Udinv, Us, sweeps=sweeps)
    if kind == "bline":
        if lines is None:
            raise ValueError("pc='bline' needs a LineStructure")
        return make_line_smoother(mesh, jac, lines, sweeps)
    if kind == "amg":
        if mg is None:
            raise ValueError("pc='amg' needs an MGHierarchy")
        from .multigrid import make_mg_preconditioner
        return make_mg_preconditioner(mesh, jac, mg, **(mg_opts or {}))
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


def make_line_smoother(mesh, jac: BlockJacobian, lines, sweeps: int = 1):
    """Line-implicit block smoother, the JAX package's: exact
    block-tridiagonal solves along strong-coupling lines (batched Thomas,
    solver/lines.py), with the off-line coupling lagged Jacobi-style
    between sweeps. The lines' elimination factors do not depend on the
    right-hand side and are computed here, once per Newton step; a sweep
    is one slot gather and product for the off-line coupling, one line
    gather, the Thomas loops and one row scatter.

    The scatter sends each line position to its cell, and the padded
    positions of the shorter lines to a dummy row NC of an (NC+1, V)
    buffer (index_copy_), which alone receives duplicates."""
    from .lines import thomas_factor, thomas_solve

    nv = jac.D.shape[-1]
    NC = jac.D.shape[0]
    dt = jac.D.dtype
    lc = lines.line_cells
    line_mask = lines.line_mask.to(dt)

    # per-line tridiagonal blocks, gathered once per Newton step
    bdiag = jac.D[lc]                                        # (NL,L,V,V)
    a = jac.N[lc, lines.dn_slot] * lines.dn_valid.to(dt)[..., None, None]
    c = jac.N[lc, lines.up_slot] * lines.up_valid.to(dt)[..., None, None]
    factor = thomas_factor(a, bdiag, c)

    # off-line neighbour blocks (everything not on the line's tridiagonal);
    # boundary slots of N are zero, so clamped in-range gathers are safe
    N_off = _slot_operand(
        jac.N * (1.0 - lines.line_slot_mask.to(dt))[..., None, None])
    nbrs_in = _nbrs_in_range(mesh)
    elems = _row_elements(nbrs_in, nv)
    scatter_idx = torch.where(lines.line_mask > 0, lc,
                              torch.full_like(lc, NC)).reshape(-1)

    def pc(v):
        z = torch.zeros_like(v)
        for _ in range(sweeps):
            r = v - _slot_apply(N_off, _gather_rows(z, elems, nbrs_in.shape))
            d = r[lc] * line_mask[..., None]                 # (NL,L,V)
            x = thomas_solve(a, factor, d)
            zfull = torch.zeros((NC + 1, nv), dtype=v.dtype, device=v.device)
            zfull.index_copy_(0, scatter_idx, x.reshape(-1, nv))
            z = zfull[:NC]
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


def _norm2(v, ar=None):
    """sqrt(sum v^2) on the device, the JAX package's norm arithmetic; with
    `ar` (an allreduce over the ranks) the sum is the global one."""
    s = torch.sum(v * v)
    return torch.sqrt(s if ar is None else ar(s))


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
          maxiter: int = 30, rtol: float = 1e-1, blocked: bool | None = None,
          allreduce: Callable | None = None):
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

    `allreduce` (a sum over the ranks, dist/comm.allreduce_sum) makes the
    same code run distributed, each rank holding its slab of the vectors:
    every inner product and norm is reduced before it is used or copied to
    the host, so every host decision (Givens, convergence, restart skip)
    is made from reduced values and all ranks take the same path. A
    distributed solve runs the classic path, as in the JAX package
    (`blocked` only without an axis).
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
        blocked = allreduce is None and n >= _BLOCKED_N_THRESHOLD
    if blocked and allreduce is not None:
        raise ValueError("a distributed gmres runs the classic path")

    mv = lambda v: matvec(v.reshape(shape)).reshape(n)
    pcf = lambda v: pc(v.reshape(shape)).reshape(n)

    bnorm = hdt(_norm2(bf, allreduce).item())
    logs.count("host_syncs")
    tol = hdt(rtol) * bnorm
    ncycles = max(1, -(-maxiter // restart))

    cycle = _cycle_blocked if blocked else _cycle_classic
    if allreduce is not None:
        cycle = functools.partial(_cycle_classic, ar=allreduce)

    x = x0.reshape(n).clone()
    iters = 0
    res = hdt(np.inf)
    for c in range(ncycles):
        if c > 0 and not res > tol:
            break               # converged restarts skip the whole cycle
        x, j, res = cycle(mv, pcf, bf, x, restart, tol, hdt)
        iters += j
    return x.reshape(shape), iters, res / np.maximum(bnorm, tiny)


def _cycle_classic(mv, pcf, bf, x, m, tol, hdt, ar=None):
    """One restart cycle of the classic CGS2 path, `ar` reducing every inner
    product over the ranks (None: one device). Returns (x, j, res)."""
    n, dtype, dev = bf.numel(), bf.dtype, bf.device
    tiny = hdt(1e-300)
    ar = ar or (lambda t: t)
    r = bf - mv(x)
    beta_d = _norm2(r, ar)
    V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
    Z = torch.zeros((m, n), dtype=dtype, device=dev)
    V[0] = r / torch.clamp_min(beta_d, 1e-300)
    beta = hdt(beta_d.item())
    logs.count("host_syncs")

    H = np.zeros((m + 1, m), hdt)
    cs = np.zeros(m, hdt)
    sn = np.zeros(m, hdt)
    g = np.zeros(m + 1, hdt)
    g[0] = beta
    j = 0
    res = beta
    while j < m and res > tol:
        with logs.span("krylov.precond"):
            z = pcf(V[j])
        w = mv(z)
        Z[j] = z

        # classical Gram-Schmidt with one re-orthogonalization pass, over
        # the j+1 filled basis rows
        Vj = V[:j + 1]
        h = ar(Vj @ w)
        w = w - Vj.T @ h
        h2 = ar(Vj @ w)
        w = w - Vj.T @ h2
        h = h + h2
        hn = _norm2(w, ar)
        V[j + 1] = w / torch.clamp_min(hn, 1e-300)
        hcol = np.zeros(m + 1, hdt)
        hcol[:j + 2] = torch.cat([h, hn[None]]).cpu().numpy()
        logs.count("host_syncs")
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
    logs.count("host_syncs")

    H = np.zeros((m + 1, m), hdt)
    cs = np.zeros(m, hdt)
    sn = np.zeros(m, hdt)
    g = np.zeros(m + 1, hdt)
    g[0] = beta
    j = 0
    res = beta
    while j < m and res > tol:
        with logs.span("krylov.precond"):
            z = pcf(V[j])
        w = mv(z)
        wn0 = _norm2(w)
        h, w = _mgs_pass(V, w, j + 1)
        hn = _norm2(w)
        wn = torch.stack([wn0, hn]).cpu().numpy()
        logs.count("host_syncs")
        # the selective second pass, decided at the Krylov dtype
        if wn[1] < hdt(0.7) * wn[0]:
            h2, w = _mgs_pass(V, w, j + 1)
            h = h + h2
            hn = _norm2(w)
        row_set(V, j + 1, w, hn)
        hcol = np.zeros(m + 1, hdt)
        hcol[:j + 2] = torch.cat([h[:j + 1], hn[None]]).cpu().numpy()
        logs.count("host_syncs")
        res = _hessenberg_column(hcol, j, cs, sn, g, tiny)
        H[:, j] = hcol
        j += 1

    if j > 0:
        y = _rows_combine(V, _least_squares(H, g, j, dev), j)
        with logs.span("krylov.precond"):
            z = pcf(y)
        x = x + z
    return x, j, res


# ---------------------------------------------------------------------------
# The device-controlled FGMRES: no host read inside a solve
# ---------------------------------------------------------------------------

class EagerControl:
    """gmres_device's control flow run eagerly: every iteration, every
    restart cycle and the blocked path's second pass are computed and their
    writes selected by their condition (torch.where), so nothing is read
    back; a dead iteration costs what a live one does. The conditions come
    from the compare-and-set kernel (graph_if.cond_set, its twin on the
    CPU), as in a graph. Inside a CUDA-graph capture,
    solver/graph_if.py:GraphControl takes its place."""
    masked = True

    @staticmethod
    def run_if(pred, body):
        body(pred)

    @staticmethod
    def run_if_cmp(op, a, b, body, scale=1.0, out=None):
        body(cond_set(op, a, b, scale, out=out))

    @staticmethod
    def run_chain(n, op, a, b, live, body, pred=None):
        cond_set(op, a, b, out=live)
        if pred is not None:
            live.logical_and_(pred)
        for j in range(n):
            body(j, None, live)


EAGER = EagerControl()


def _sel(pred, new, old):
    """new where `pred` holds (None: always), else old."""
    return new if pred is None else torch.where(pred, new, old)


class KrylovWorkspace:
    """The device state of gmres_device: the basis (and, on the classic
    path, the preconditioned directions), the Hessenberg matrix, the
    rotations, g, the solution and the scalars the Givens kernel updates.
    Allocated once per (n, restart, dtype, device, path) and rewritten by
    every cycle of every solve, so that a captured graph writes the same
    memory at each replay and the K steps of a captured chunk share it."""

    def __init__(self, n: int, m: int, dtype, device, blocked: bool):
        z = functools.partial(torch.zeros, dtype=dtype, device=device)
        self.key = (n, m, dtype, torch.device(device), blocked)
        rows = -(-(m + 1) // _ROW_BLOCK) * _ROW_BLOCK if blocked else m + 1
        self.V = z((rows, n))
        self.Z = None if blocked else z((m, n))
        self.row = z((1, n)) if blocked else None   # masked row_set target
        self.H = z((m + 1, m))
        self.cs, self.sn, self.g = z(m), z(m), z(m + 1)
        self.x, self.res = z(n), z(())
        self.live = torch.zeros((), dtype=torch.bool, device=device)
        self.iters = torch.zeros((), dtype=torch.int32, device=device)


def gmres_device(matvec: Callable, b, x0, pc: Callable, rtol,
                 restart: int = 30, maxiter: int = 30,
                 blocked: bool | None = None, ws: KrylovWorkspace = None,
                 ctl=EAGER, allreduce: Callable | None = None):
    """gmres with its control on the device: the counterpart of the JAX
    package's gmres (lax.while_loop over the iterations, lax.cond over the
    blocked path's second pass and the restarts), on one device.

    The same two paths and arithmetic as gmres, iteration for iteration:
    the same products over the filled basis rows (the host loop index j
    bounds them), the Givens rotations by the givens_column kernel (its
    twin on the CPU), which also keeps the residual estimate, the
    convergence flag `live` and the iteration count on the device. Where
    gmres reads back, this keeps device tensors:

      - tol = rtol * ||b|| (rtol a 0-dim tensor, or a float);
      - each of the `restart` iterations of a cycle runs under `live`, the
        blocked path's second pass under wn1 < 0.7 wn0, a cycle after the
        first under res > tol, through `ctl`: EAGER computes every branch
        and selects its writes, a graph_if.GraphControl captures each into
        an IF node of a CUDA graph (the iterations a chain whose next node
        the Givens update decides, in groups; the other decisions by the
        compare-and-set kernel);
      - the least-squares solve runs over all `restart` columns with the
        unused ones made identity and their g zero, so y is 0 past the
        cycle's iterations and x += Z^T y (blocked: pc(V^T y)) reads the
        zero rows the cycle did not fill. Only this update's rounding can
        differ from gmres's (a product over restart rather than j rows).

    `allreduce` (a sum over the ranks, dist/comm.allreduce_sum) makes it
    run distributed, as gmres(allreduce=) does: ||b||, each cycle's beta and
    each iteration's h, h2 and norm are reduced before they are used, so
    the Givens kernel, the compare-and-set kernel and every node decide
    from values that are the same bits on every rank and all ranks take
    the same path (in a graph: replay the same nodes). The classic path
    only, as gmres.

    `ws`: the KrylovWorkspace to write (a new one when None). Returns (x,
    iterations, relres) as device tensors: x like b, iterations int32."""
    if b.is_cuda:
        # the f32 Arnoldi products must run in full f32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    shape, n, dtype, dev = b.shape, b.numel(), b.dtype, b.device
    if blocked is None:
        blocked = allreduce is None and n >= _BLOCKED_N_THRESHOLD
    if blocked and allreduce is not None:
        raise ValueError("a distributed gmres_device runs the classic path")
    m = restart
    if ws is None:
        ws = KrylovWorkspace(n, m, dtype, dev, blocked)
    if ws.key != (n, m, dtype, torch.device(dev), blocked):
        raise ValueError(f"workspace {ws.key} does not fit a solve of "
                         f"{(n, m, dtype, dev, blocked)}")
    if not torch.is_tensor(rtol):
        rtol = torch.full((), rtol, dtype=torch.float64, device=dev)
    bf = b.reshape(n)
    mv = lambda v: matvec(v.reshape(shape)).reshape(n)
    pcf = lambda v: pc(v.reshape(shape)).reshape(n)

    bnorm = _norm2(bf, allreduce)
    tol = rtol.to(dtype) * bnorm
    ws.x.copy_(x0.reshape(n))
    ws.iters.zero_()
    ws.res.fill_(float("inf"))
    cycle = functools.partial(_device_cycle, ws, mv, pcf, bf, m, tol, ctl,
                              blocked, allreduce)
    for c in range(max(1, -(-maxiter // restart))):
        if c == 0:
            cycle(None)
        else:
            # converged restarts skip the whole cycle
            ctl.run_if_cmp(GREATER, ws.res, tol, cycle)
    return (ws.x.clone().reshape(shape), ws.iters.clone(),
            ws.res / torch.clamp_min(bnorm, 1e-300))


def _device_cycle(ws, mv, pcf, bf, m, tol, ctl, blocked, ar, pred):
    """One restart cycle of gmres_device, its writes selected by `pred`
    (None inside a conditional node: it runs); `ar` the sum over the ranks
    (None: one device)."""
    x = ws.x
    r = bf - mv(x)
    beta = _norm2(r, ar)
    it0 = ws.iters.clone()
    for t in (ws.V, ws.Z, ws.H, ws.cs, ws.sn, ws.g):
        if t is not None:
            t.zero_()
    ws.V[0] = r / torch.clamp_min(beta, 1e-300)
    ws.g[0] = beta
    ws.res.copy_(_sel(pred, beta, ws.res))
    step = (_blocked_iteration if blocked else
            functools.partial(_classic_iteration, ar=ar))
    # live = beta > tol decides the first iteration, each Givens update the
    # next
    ctl.run_chain(m, GREATER, beta, tol, ws.live,
                  functools.partial(step, ws, mv, pcf, tol, ctl), pred)

    jc = ws.iters - it0
    used = torch.arange(m, device=x.device) < jc
    R = ws.H[:m] * (used[:, None] & used[None, :])
    R = R + torch.diag((~used).to(R.dtype))
    rhs = torch.where(used, ws.g[:m], 0.0)
    y = torch.linalg.solve_triangular(R, rhs[:, None], upper=True)[:, 0]
    if blocked:
        upd = x + pcf(ws.V[:m].T @ y)
    else:
        upd = x + ws.Z.T @ y
    x.copy_(torch.where(jc > 0, upd, x))


def _classic_iteration(ws, mv, pcf, tol, ctl, j, nxt, pred, ar=None):
    """Iteration j of the classic path: gmres's CGS2 over the j+1 filled
    rows, its products reduced by `ar` as _cycle_classic's, then the Givens
    kernel (which decides `nxt`, the next iteration's node)."""
    V = ws.V
    ar_ = ar or (lambda t: t)
    z = pcf(V[j])
    w = mv(z)
    Vj = V[:j + 1]
    h = ar_(Vj @ w)
    w = w - Vj.T @ h
    h2 = ar_(Vj @ w)
    w = w - Vj.T @ h2
    h = h + h2
    hn = _norm2(w, ar)
    V[j + 1] = _sel(pred, w / torch.clamp_min(hn, 1e-300), V[j + 1])
    ws.Z[j] = _sel(pred, z, ws.Z[j])
    givens_column(h, hn, j, ws.H, ws.cs, ws.sn, ws.g, ws.res, tol, ws.live,
                  ws.iters, next_cond=nxt)


def _blocked_iteration(ws, mv, pcf, tol, ctl, j, nxt, pred):
    """Iteration j of the blocked path: one blocked-MGS pass, the second
    under wn1 < 0.7 wn0 (a nested conditional: the compare-and-set kernel
    decides it at the Krylov dtype, as gmres does), the row_set append and
    the Givens kernel (which decides `nxt`, the next iteration's node)."""
    V = ws.V
    w = mv(pcf(V[j]))
    wn0 = _norm2(w)
    h, w = _mgs_pass(V, w, j + 1)
    hn = _norm2(w)
    if ctl.masked:
        again = cond_set(LESS, hn, wn0, 0.7)
        h2, w2 = _mgs_pass(V, w, j + 1)
        h = torch.where(again, h + h2, h)
        w = torch.where(again, w2, w)
        hn = torch.where(again, _norm2(w2), hn)
        row_set(ws.row, 0, w, hn)
        V[j + 1] = _sel(pred, ws.row[0], V[j + 1])
    else:
        def second_pass(_):
            h2, w2 = _mgs_pass(V, w, j + 1)
            h.add_(h2)
            w.copy_(w2)
            hn.copy_(_norm2(w2))
        ctl.run_if_cmp(LESS, hn, wn0, second_pass, scale=0.7)
        row_set(V, j + 1, w, hn)
    givens_column(h[:j + 1], hn, j, ws.H, ws.cs, ws.sn, ws.g, ws.res, tol,
                  ws.live, ws.iters, next_cond=nxt)


def _cholqr(A, k: int, ar):
    """Rows of A (k, n) -> (L^-1 A, L) with L = chol(ar(A A^T)): orthonormal
    rows over the ranks from one reduced k x k Gram, the JAX package's
    Cholesky-QR. The jittered Gram diagonal plays the QR path's
    rank-deficiency clamp; a Gram that is not positive definite gives
    L = I. L^-1 is formed from the identity: a triangular solve with n
    right-hand sides is the slow form on the card (see gmres_dr)."""
    G = ar(A @ A.T)
    dtype, dev = A.dtype, A.device
    eye = torch.eye(k, dtype=dtype, device=dev)
    eps = (1e-12 * torch.trace(G) / max(k, 1)
           + (1e-300 if dtype == torch.float64 else 1e-37))
    L, info = torch.linalg.cholesky_ex(G + eps * eye)
    if int(info) != 0 or not bool(torch.isfinite(L).all()):
        L = eye
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv @ A, L


def gmres_dr(matvec: Callable, b, x0, pc: Callable, U=None, k: int = 16,
             restart: int = 30, maxiter: int = 30, rtol: float = 1e-1,
             allreduce: Callable | None = None):
    """Deflated/recycling right-preconditioned GMRES (GCRO-DR class), the
    JAX package's gmres_dr on one device: carry k approximate slow
    directions of the slowly varying Jacobian across Newton steps and
    deflate them from every solve.

    Scheme (GCRO with an SVD harvest: Parks et al.'s GCRO-DR with the
    harmonic-Ritz eigenproblem replaced by an SVD of the relation
    A [U;Z] = [C;V] G):
      setup    C R = qr(A U),  U <- R^-T U       (so A U = C, C orthonormal)
      init     x += U^T (C r0), r -= C^T (C r0)
      Arnoldi  on (I - C^T C) A M^-1, storing B = C A Z
      update   x += Z^T y - U^T (B y)
      harvest  k smallest right singular vectors of G = [[I,B],[0,Hbar]]
               -> U' = Y^T [U;Z], re-orthonormalized

    The Arnoldi loop is gmres's classic path at every size (two full CGS
    passes, stored Z, host Givens); the k setup matvecs are k calls of
    matvec, the QRs torch.linalg.qr on the device, R^-T U a product with
    the k x k inverse, the small SVD of G on the host at the Krylov
    dtype. As in the JAX package, G holds the
    Givens-rotated Hessenberg columns.

    U: (k,)+b.shape recycled directions from the previous solve, or None
    (first call: plain projected Arnoldi, harvest only). Returns (x, iters,
    relres, U_new) with U_new shaped like U.

    `allreduce`: as gmres's, each rank holding its slab of the vectors;
    every projection (C r, C w, the Arnoldi products and norms) is reduced,
    and the two tall-skinny QRs (A U^T at set-up and the harvest's
    orthonormalization) become Cholesky-QR with a reduced k x k Gram
    (_cholqr), as in the JAX package."""
    if b.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    shape = b.shape
    n = b.numel()
    dtype, dev = b.dtype, b.device
    hdt = np.float32 if dtype == torch.float32 else np.float64
    tiny = hdt(1e-300)
    bf = b.reshape(n)
    mv = lambda v: matvec(v.reshape(shape)).reshape(n)
    pcf = lambda v: pc(v.reshape(shape)).reshape(n)
    dist = allreduce is not None
    ar = allreduce if dist else (lambda t: t)

    bnorm = hdt(_norm2(bf, ar).item())
    logs.count("host_syncs")
    tol = hdt(rtol) * bnorm
    m = restart
    ncycles = max(1, -(-maxiter // restart))
    have_U = U is not None

    if have_U:
        Ur = U.reshape(k, n).to(dtype)
        AU = torch.stack([mv(Ur[i]) for i in range(k)])     # (k, n)
    if have_U and dist:
        C, L = _cholqr(AU, k, ar)                   # C = R^-T (A U), L = R^T
        eye = torch.eye(k, dtype=dtype, device=dev)
        Ur = torch.linalg.solve_triangular(L, eye, upper=False) @ Ur
    elif have_U:
        Q, R = torch.linalg.qr(AU.T)                        # A U^T = Q R
        # a rank-deficient recycle space: clamp tiny R diagonals so the
        # triangular solve stays finite (those directions then deflate
        # nothing instead of poisoning the solve)
        d = torch.diagonal(R)
        dsafe = torch.where(d.abs() > 1e-30, d, torch.full_like(d, 1e-30))
        R = R - torch.diag(d) + torch.diag(dsafe)
        C = Q.T                                             # (k, n)
        # U <- R^-T U through the k x k inverse: a triangular solve with
        # n right-hand sides takes 8.8 s on an H100 at n = 819,200 (the
        # product 0.14 ms)
        eye = torch.eye(k, dtype=dtype, device=dev)
        Ur = torch.linalg.solve_triangular(R.T, eye, upper=False) @ Ur
    else:
        C = Ur = None

    def cycle(x):
        r = bf - mv(x)
        if have_U:
            q = ar(C @ r)
            x = x + Ur.T @ q
            r = r - C.T @ q
        beta_d = _norm2(r, ar)
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        Z = torch.zeros((m, n), dtype=dtype, device=dev)
        B = torch.zeros((k, m), dtype=dtype, device=dev)
        V[0] = r / torch.clamp_min(beta_d, 1e-300)
        beta = hdt(beta_d.item())
        logs.count("host_syncs")
        H = np.zeros((m + 1, m), hdt)
        cs = np.zeros(m, hdt)
        sn = np.zeros(m, hdt)
        g = np.zeros(m + 1, hdt)
        g[0] = beta
        j = 0
        res = beta
        while j < m and res > tol:
            with logs.span("krylov.precond"):
                z = pcf(V[j])
            w = mv(z)
            Z[j] = z
            if have_U:
                bcol = ar(C @ w)
                w = w - C.T @ bcol
                B[:, j] = bcol
            Vj = V[:j + 1]
            h = ar(Vj @ w)
            w = w - Vj.T @ h
            h2 = ar(Vj @ w)
            w = w - Vj.T @ h2
            h = h + h2
            hn = _norm2(w, ar)
            V[j + 1] = w / torch.clamp_min(hn, 1e-300)
            hcol = np.zeros(m + 1, hdt)
            hcol[:j + 2] = torch.cat([h, hn[None]]).cpu().numpy()
            logs.count("host_syncs")
            res = _hessenberg_column(hcol, j, cs, sn, g, tiny)
            H[:, j] = hcol
            j += 1
        if j > 0:
            y = _least_squares(H, g, j, dev)
            x = x + Z[:j].T @ y
            if have_U:
                x = x - Ur.T @ (B[:, :j] @ y)
        return x, j, res, (Z, B, H, j)

    x = x0.reshape(n).clone()
    iters = 0
    res = hdt(np.inf)
    for c in range(ncycles):
        if c > 0 and not res > tol:
            break               # converged restarts skip the whole cycle
        x, j, res, arn = cycle(x)
        iters += j

    # harvest the next recycle space from the last cycle's relation
    # A [Ur; Z] = [C; V] G,  G = [[I_k, B], [0, Hbar]]
    Z, B, H, j = arn
    used = np.arange(m) < j
    G = np.zeros((k + m + 1, k + m), hdt)
    if have_U:
        G[:k, :k] = np.eye(k, dtype=hdt)
        G[:k, k:] = B.cpu().numpy() * used[None, :]
        logs.count("host_syncs")
    G[k:, k:] = H * used[None, :]
    # unused Arnoldi columns get a huge unit diagonal so their singular
    # triplets sort to the top and are never harvested
    G[np.arange(k, k + m), np.arange(k, k + m)] += np.where(used, 0.0,
                                                            1e8).astype(hdt)
    if not have_U:
        # without a previous space the first k columns are all zero: the
        # same huge diagonal keeps them from being selected
        G[np.arange(k), np.arange(k)] = hdt(1e8)
    _, _, Vh = torch.linalg.svd(torch.from_numpy(G), full_matrices=False)
    Y = Vh[-k:, :].to(dev)                          # k smallest, (k, k+m)
    U_new = Y[:, k:] @ Z
    if have_U:
        U_new = U_new + Y[:, :k] @ Ur
    # orthonormalize the harvested space (its span is what matters; C is
    # rebuilt from A U in the next solve): without this the recycled
    # directions collapse toward the same slow modes across Newton steps
    U_new = torch.where(torch.isfinite(U_new), U_new,
                        torch.zeros_like(U_new))
    if dist:
        U_new, _ = _cholqr(U_new, k, ar)
    else:
        U_new = torch.linalg.qr(U_new.T)[0].T       # (k, n) orthonormal
    return (x.reshape(shape), iters, res / np.maximum(bnorm, tiny),
            U_new.reshape((k,) + shape))
