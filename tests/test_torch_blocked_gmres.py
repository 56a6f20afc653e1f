"""The port's blocked GMRES against the JAX package's, and the basis row
append (row_set) that it writes each new Krylov vector with.

Systems: the banded operators (bsgs x6) of the inviscid cylinder case's
Jacobian on cylinder_omesh(32, 16), and a dense well-conditioned system.
Both packages run gmres(..., blocked=True) on the same inputs:
  - f64: x to 1e-12 of max|x|, equal iterations (the same arithmetic; the
    Givens work runs on the host in the port, on the device in JAX, both
    at f64);
  - f32: x to 1e-5 of max|x|, iterations within 1 (f32 products summed in
    another order).
The cases include restarts (maxiter > restart), and the selective second
MGS pass both ways: it fires on the near-identity operator, whose new
Krylov vector is mostly the old one, and never on the shifted cycle, whose
new vector is mostly orthogonal to the basis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvens_tpu.solver import banded as jb
from fvens_tpu.solver import jacobian as jjac
from fvens_tpu.solver import pallas_banded as pb
from fvens_tpu.solver.linear import block_jacobi_inverse as jax_bjinv
from fvens_tpu.solver.linear import gmres as jax_gmres
from fvens_tpu_torch import interop
from fvens_tpu_torch.solver import banded as tb
from fvens_tpu_torch.solver import linear
from fvens_tpu_torch.solver import rowset_kernels as rk
from fvens_tpu_torch.solver.linear import block_jacobi_inverse, gmres

from test_torch_residual import cyl_meshes, jax_cyl_space

TOL = {np.float64: 1e-12, np.float32: 1e-5}
ITERS = {np.float64: 0, np.float32: 1}


def _banded_systems(dtype, cfl):
    """(JAX (mv, pc), port (mv, pc), b): the cylinder case's banded
    operators at a perturbed free stream with the pseudo-time term at
    `cfl`, at `dtype`."""
    jm, tm = cyl_meshes(32, 16)
    js, res, jac = jax_cyl_space()
    u = np.tile(np.asarray(js.uinf), (jm.NC, 1))
    u = u * (1.0 + 0.01 * np.random.default_rng(3).standard_normal(u.shape))
    J = jac(jm, jnp.asarray(u))
    J = jjac.add_pseudotime_term(jm, J, cfl, res(jm, jnp.asarray(u))[1])
    D, N = np.asarray(J.D, dtype), np.asarray(J.N, dtype)
    blj, blt = jb.banded_structure(jm), tb.banded_structure(tm)
    Dj, Nj = jnp.asarray(D), jnp.asarray(N)
    Dinv_j = jax_bjinv(Dj)
    mv_j = jb.make_banded_matvec(Dj, jb.banded_blocks(blj, Nj), blj.offsets)
    pc_j = jb.make_banded_bsgs(Dinv_j, jb.banded_dn_blocks(blj, Dinv_j, Nj),
                               blj.offsets, 6)
    Jt = interop.jacobian_from_numpy(D, N, device="cpu")
    Dinv_t = block_jacobi_inverse(Jt.D)
    mv_t = tb.make_banded_matvec(Jt.D, tb.banded_blocks(blt, Jt.N),
                                 blt.offsets)
    pc_t = tb.make_banded_bsgs(Dinv_t, tb.banded_dn_blocks(blt, Dinv_t, Jt.N),
                               blt.offsets, 6)
    b = np.random.default_rng(7).standard_normal((tm.NC, 4)).astype(dtype)
    b[tm.n_cells:] = 0.0
    return (mv_j, pc_j), (mv_t, pc_t), b


def _dense_systems(dtype, kind):
    """A dense (n, n) system on (64, 4) vectors, preconditioned by the
    inverse of its diagonal: "spread" is diag(1..50) plus a small random
    part, "near_identity" the same with diag(1), "shift" the cyclic shift
    plus 0.6 I (|A v|^2 = 1.36 |v|^2, of which the basis takes about 0.36)."""
    rng = np.random.default_rng(11)
    n = 256
    if kind == "shift":
        d = np.full(n, 0.6)
        A = np.diag(d) + np.roll(np.eye(n), 1, axis=0)
    else:
        d = np.linspace(1.0, 50.0 if kind == "spread" else 1.0, n)
        A = np.diag(d) + 0.2 * rng.standard_normal((n, n)) / np.sqrt(n)
    A = A.astype(dtype)
    dinv = (1.0 / d).astype(dtype)
    Aj, Dj = jnp.asarray(A), jnp.asarray(dinv)
    At, Dt = torch.from_numpy(A), torch.from_numpy(dinv)
    mv_j = lambda v: (Aj @ v.reshape(-1)).reshape(v.shape)
    pc_j = lambda v: (Dj * v.reshape(-1)).reshape(v.shape)
    mv_t = lambda v: (At @ v.reshape(-1)).reshape(v.shape)
    pc_t = lambda v: (Dt * v.reshape(-1)).reshape(v.shape)
    b = rng.standard_normal((64, 4)).astype(dtype)
    return (mv_j, pc_j), (mv_t, pc_t), b


def _run_both(systems, restart, maxiter, rtol, monkeypatch):
    """Both packages' blocked gmres from x0 = 0. Returns (JAX (x, it, rr),
    port (x, it, rr), the port's _mgs_pass calls)."""
    (mv_j, pc_j), (mv_t, pc_t), b = systems
    run = jax.jit(lambda bb: jax_gmres(mv_j, bb, jnp.zeros_like(bb), pc_j,
                                       restart=restart, maxiter=maxiter,
                                       rtol=rtol, blocked=True))
    xj, itj, rrj = run(jnp.asarray(b))
    passes = []
    mgs = linear._mgs_pass

    def counted(*a):
        passes.append(a[2])
        return mgs(*a)
    monkeypatch.setattr(linear, "_mgs_pass", counted)
    bt = torch.from_numpy(b)
    xt, itt, rrt = gmres(mv_t, bt, torch.zeros_like(bt), pc_t,
                         restart=restart, maxiter=maxiter, rtol=rtol,
                         blocked=True)
    return (np.asarray(xj), int(itj), float(rrj)), (xt, itt, rrt), passes


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("system,restart,maxiter,rtol", [
    ("banded50", 90, 90, 1e-8),       # one cycle, converges inside it
    ("banded500", 10, 100, 1e-5),     # restarts: converges in a later cycle
    ("banded500", 8, 16, 1e-12),      # stops at maxiter without converging
    ("dense_near_identity", 12, 48, 1e-10),
    ("dense_spread", 20, 60, 1e-8),
    ("dense_shift", 10, 30, 1e-3),
])
def test_blocked_gmres_matches_jax(system, restart, maxiter, rtol, dtype,
                                   monkeypatch):
    if system.startswith("banded"):
        systems = _banded_systems(dtype, float(system[6:]))
    else:
        systems = _dense_systems(dtype, system[6:])
    (xj, itj, rrj), (xt, itt, rrt), passes = _run_both(
        systems, restart, maxiter, rtol, monkeypatch)
    assert isinstance(itt, int) and abs(itt - itj) <= ITERS[dtype]
    assert itt <= maxiter
    assert xt.numpy().dtype == xj.dtype
    assert np.abs(xt.numpy() - xj).max() <= TOL[dtype] * np.abs(xj).max()
    if dtype == np.float64:
        # relres is |g[j]|/|b|, rounded at ~1e-16 of |b| however small
        assert abs(float(rrt) - rrj) <= 1e-8 * rrj + 1e-14
    if itt < maxiter:
        assert float(rrt) <= rtol
    # one MGS pass per iteration, plus the selective second ones
    assert itt <= len(passes) <= 2 * itt
    if system == "dense_near_identity":
        assert len(passes) > itt          # the second pass fired
    if system == "dense_shift":
        assert len(passes) == itt         # ... and here it never did


def test_blocked_is_selected_from_the_threshold(monkeypatch):
    """blocked=None takes the blocked path at n >= _BLOCKED_N_THRESHOLD
    (262,144), read when gmres is called, and the classic path below."""
    taken = []

    def fake(name):
        def cycle(mv, pcf, bf, x, m, tol, hdt):
            taken.append(name)
            return x, 1, hdt(0.0)
        return cycle
    monkeypatch.setattr(linear, "_cycle_blocked", fake("blocked"))
    monkeypatch.setattr(linear, "_cycle_classic", fake("classic"))
    ident = lambda v: v
    for nc in (65_535, 65_536):          # n = 262,140 and 262,144
        b = torch.ones(nc, 4, dtype=torch.float32)
        gmres(ident, b, torch.zeros_like(b), ident)
    assert taken == ["classic", "blocked"]
    b = torch.ones(16, 4)
    gmres(ident, b, torch.zeros_like(b), ident, blocked=False)
    monkeypatch.setattr(linear, "_BLOCKED_N_THRESHOLD", 64)
    gmres(ident, b, torch.zeros_like(b), ident)
    gmres(ident, b, torch.zeros_like(b), ident, blocked=False)
    assert taken == ["classic", "blocked", "classic", "blocked", "classic"]


@pytest.mark.parametrize("restart,maxiter,mpad", [(90, 90, 96),
                                                   (30, 60, 32)])
def test_basis_is_written_in_place(restart, maxiter, mpad, monkeypatch):
    """The blocked path allocates its (ceil((restart+1)/8)*8, n) basis once
    per cycle and writes every new row into it in place through row_set."""
    seen = []
    rs = linear.row_set

    def spy(V, j, w, hn):
        seen.append((V.data_ptr(), tuple(V.shape), j))
        out = rs(V, j, w, hn)
        assert out is V
        return out
    monkeypatch.setattr(linear, "row_set", spy)
    _, (mv_t, pc_t), b = _banded_systems(np.float64, 500.0)
    bt = torch.from_numpy(b)
    _, it, _ = gmres(mv_t, bt, torch.zeros_like(bt), pc_t, restart=restart,
                     maxiter=maxiter, rtol=1e-12, blocked=True)
    assert len(seen) == it > 30
    assert all(shape == (mpad, bt.numel()) for _, shape, _ in seen)
    cycles = [seen[i:i + restart] for i in range(0, it, restart)]
    assert len(cycles) == -(-it // restart)
    for cyc in cycles:
        assert [j for _, _, j in cyc] == list(range(1, len(cyc) + 1))
        assert len({p for p, _, _ in cyc}) == 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rowset_plain_is_the_jax_row_write(dtype):
    """rowset_plain equals V.at[j].set(w / max(hn, tiny)) bit for bit at
    n = 262,528, where the TPU kernel's tile gate refuses the row."""
    n, rows, j = 262_528, 16, 9
    rng = np.random.default_rng(5)
    V = rng.standard_normal((rows, n)).astype(dtype)
    w = rng.standard_normal(n).astype(dtype)
    hn = np.sqrt(np.sum(w * w, dtype=dtype)).astype(dtype)
    want = jnp.asarray(V).at[j].set(jnp.asarray(w) / jnp.maximum(
        jnp.asarray(hn), 1e-300))
    Vt = torch.from_numpy(V.copy())
    ptr = Vt.data_ptr()
    out = rk.rowset_plain(Vt, j, torch.from_numpy(w), torch.tensor(hn))
    assert out is Vt and Vt.data_ptr() == ptr
    assert np.array_equal(Vt.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        pb.row_set(jnp.asarray(V), jnp.asarray(w), j, interpret=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_set_routes_cpu_to_twin(dtype):
    """On CPU tensors the wrapper writes through the twin in place, launches
    nothing, leaves the other rows alone, and clamps the norm as the JAX
    package does: at 1e-300 in f64, at 0 in f32; a NaN norm stays NaN."""
    g = torch.Generator().manual_seed(0)
    V = torch.randn(8, 37, generator=g, dtype=dtype)
    V0 = V.clone()
    w = torch.randn(37, generator=g, dtype=dtype)
    before = rk.row_set.launches
    assert rk.row_set(V, 3, w, torch.tensor(2.0, dtype=dtype)) is V
    assert rk.row_set.launches == before
    assert torch.equal(V[3], w / 2.0)
    keep = [i for i in range(8) if i != 3]
    assert torch.equal(V[keep], V0[keep])
    rk.row_set(V, 5, w, torch.zeros((), dtype=dtype))
    if dtype == torch.float64:
        assert torch.equal(V[5], w / 1e-300)
    else:
        assert torch.isinf(V[5]).all()
    rk.row_set(V, 6, w, torch.tensor(float("nan"), dtype=dtype))
    assert torch.isnan(V[6]).all()
    # a row of a strided view
    big = torch.zeros(8, 50, dtype=dtype)
    rk.row_set(big[:, :37], 2, w, torch.tensor(4.0, dtype=dtype))
    assert torch.equal(big[2, :37], w / 4.0) and not big[2, 37:].any()


def test_row_set_checks_inputs():
    V = torch.zeros(8, 16)
    w = torch.zeros(16)
    hn = torch.ones(())
    with pytest.raises(ValueError):
        rk.row_set(V, 8, w, hn)                        # row out of range
    with pytest.raises(ValueError):
        rk.row_set(V, 0, torch.zeros(15), hn)          # wrong length
    with pytest.raises(ValueError):
        rk.row_set(V, 0, w, torch.ones(2))             # not one norm
    with pytest.raises(TypeError):
        rk.row_set(V, 0, w.double(), hn)               # mixed dtypes
    with pytest.raises(TypeError):
        rk.row_set(V.half(), 0, w.half(), hn.half())   # unsupported dtype
    with pytest.raises(ValueError):
        rk.row_set(torch.zeros(16, 8).T, 0, w, hn)     # rows not contiguous
