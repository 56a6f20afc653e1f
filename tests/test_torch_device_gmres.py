"""The device-controlled FGMRES of the port (solver/linear.py:gmres_device)
and the plain twin of its Givens kernel (solver/givens_kernels.py), on the
CPU.

  - givens_plain against the host's _hessenberg_column on random columns
    (hypothesis: j up to 89 of a restart of 90, f32 and f64, with a NaN
    column among them): bit for bit wherever NumPy's scalar ** 2 rounds
    the two squares as the products the twin and the JAX package form,
    within 2 ulps where it does not (about one square in 1,500), and bit
    for bit always against the same NumPy arithmetic with products; a
    dead call (live false) changing nothing;
  - gmres_device, classic and blocked, on the inviscid cylinder case's
    banded operators (bsgs x6, cylinder_omesh(32, 16)) and on dense
    systems, with restarts: against the JAX package's gmres and the
    port's host-controlled gmres on the same inputs, iterations equal and
    x to 1e-10 of max|x| at f64 (the same arithmetic but for the final
    update, a product over the restart's columns rather than the cycle's);
  - the device-form step (SteadyBackwardEuler._device_step) equal to the
    host step, and run under a dispatch mode that raises on every
    operation that reads a tensor back to the host (.item(), bool() of a
    tensor, nonzero, a tensor made from host data): it reads nothing;
  - gmres_device(allreduce=): with an identity allreduce bit for bit the
    one-device classic gmres_device; refusing the blocked path; on two
    gloo ranks (tests/torch_dist_ranks.py:gmres_pairs, the Krylov system
    of a distributed implicit step) the host gmres(allreduce=)'s Krylov
    iterations and its x to 1e-12 relative at f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fvens_tpu.solver.linear import gmres as jax_gmres
from fvens_tpu_torch.solver import linear
from fvens_tpu_torch.solver.givens_kernels import givens_column
from fvens_tpu_torch.solver.linear import (_hessenberg_column, gmres,
                                           gmres_device)

import torch_dist_ranks as R
from test_torch_blocked_gmres import _banded_systems, _dense_systems
from torch_dist_ranks import NoHostRead as _NoHostRead

RESTART = 90
DTYPES = {np.float32: torch.float32, np.float64: torch.float64}


def _krylov_state(rng, j, hdt):
    """A plausible state before iteration j: j rotations (c, s on the unit
    circle), g, and the new column's j + 1 projections and norm."""
    theta = rng.uniform(-np.pi, np.pi, RESTART)
    cs = np.cos(theta).astype(hdt)
    sn = np.sin(theta).astype(hdt)
    cs[j:] = sn[j:] = 0
    g = np.zeros(RESTART + 1, hdt)
    g[:j + 1] = rng.standard_normal(j + 1) * 10.0 ** rng.uniform(-8, 2)
    h = (rng.standard_normal(j + 1)
         * 10.0 ** rng.uniform(-5, 5, j + 1)).astype(hdt)
    hn = hdt(abs(rng.standard_normal()) * 10.0 ** rng.uniform(-12, 3))
    return cs, sn, g, h, hn


def _twin(j, cs, sn, g, h, hn, tol, hdt, live=True):
    dt = DTYPES[hdt]
    t = lambda a: torch.tensor(np.asarray(a), dtype=dt)
    H = torch.full((RESTART + 1, RESTART), 7.0, dtype=dt)
    state = dict(H=H, cs=t(cs), sn=t(sn), g=t(g), res=t(hdt(-1.0)),
                 live=torch.tensor(live), iters=torch.tensor(
                     3, dtype=torch.int32))
    givens_column(t(h), t(hn), j, state["H"], state["cs"], state["sn"],
                  state["g"], state["res"], t(tol), state["live"],
                  state["iters"])
    return state


def _column_with_products(hcol, j, cs, sn, g, tiny):
    """_hessenberg_column's NumPy arithmetic with its two squares formed as
    products, as the JAX package's XLA forms x ** 2, in place. Returns
    (|g[j+1]|, whether NumPy's scalar ** 2 rounds both squares to the
    products)."""
    for i in range(j):
        t1 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
        t2 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
        hcol[i], hcol[i + 1] = t1, t2
    a, b = hcol[j], hcol[j + 1]
    with np.errstate(invalid="ignore"):
        same = bool((a ** 2 == a * a or np.isnan(a))
                    and (b ** 2 == b * b or np.isnan(b)))
    denom = np.sqrt(a * a + b * b)
    with np.errstate(invalid="ignore", divide="ignore"):
        c_new = a / np.maximum(denom, tiny)
        s_new = b / np.maximum(denom, tiny)
    hcol[j], hcol[j + 1] = denom, 0.0
    cs[j], sn[j] = c_new, s_new
    g[j + 1] = -s_new * g[j]
    g[j] = c_new * g[j]
    return np.abs(g[j + 1]), same


@settings(max_examples=60, deadline=None)
@given(j=st.integers(0, RESTART - 1), seed=st.integers(0, 2 ** 31),
       f64=st.booleans(), nan=st.booleans())
def test_givens_twin_equals_the_host_column(j, seed, f64, nan):
    """The twin against the host's _hessenberg_column: bit for bit wherever
    NumPy's scalar ** 2 rounds the two squares as products (all but about
    one square in 1,500), within 2 ulps of each entry elsewhere; and bit for
    bit always against the same NumPy arithmetic with products."""
    hdt = np.float64 if f64 else np.float32
    rng = np.random.default_rng(seed)
    cs, sn, g, h, hn = _krylov_state(rng, j, hdt)
    if nan:
        h[rng.integers(j + 1)] = np.nan
    tol = hdt(abs(g[0]) * 1e-3)
    got = _twin(j, cs, sn, g, h, hn, tol, hdt)
    for host in (True, False):
        want = dict(cs=cs.copy(), sn=sn.copy(), g=g.copy(),
                    H=np.zeros(RESTART + 1, hdt))
        want["H"][:j + 1], want["H"][j + 1] = h, hn
        args = (want["H"], j, want["cs"], want["sn"], want["g"],
                hdt(1e-300))
        if host:
            res = _hessenberg_column(*args)
            exact = _column_with_products(
                *((a.copy() if isinstance(a, np.ndarray) else a)
                  for a in args))[1]
        else:
            res, exact = _column_with_products(*args)[0], True
        want["res"] = res
        pairs = [(got[k].numpy(), want[k]) for k in ("cs", "sn", "g", "res")]
        pairs.append((got["H"][:, j].numpy(), want["H"]))
        for a, b in pairs:
            if exact:
                assert np.array_equal(a, b, equal_nan=True), (host, a, b)
            else:
                assert np.allclose(a, b, rtol=2 * np.finfo(hdt).eps,
                                   atol=0, equal_nan=True), (a, b)
        if exact:
            assert bool(got["live"]) == bool(res > tol and j + 1 < RESTART)
    assert np.array_equal(got["H"][:, :j].numpy(),
                          np.full((RESTART + 1, j), 7.0, hdt))
    assert int(got["iters"]) == 4
    assert not nan or not bool(got["live"])


def test_givens_twin_where_numpy_rounds_a_square_by_pow():
    """A column whose rotated entry's square NumPy's scalar ** 2 rounds to
    the other neighbour of the product: the twin takes the product (the
    JAX package's arithmetic), the host its pow, and the two differ in the
    last bit only."""
    rng = np.random.default_rng(0)
    for _ in range(100000):
        a = np.float32(rng.standard_normal() * 10.0 ** rng.integers(-3, 3))
        if a ** 2 != a * a:
            break
    else:
        pytest.skip("no misrounded square found")
    hdt = np.float32
    cs, sn = np.zeros(RESTART, hdt), np.zeros(RESTART, hdt)
    g = np.zeros(RESTART + 1, hdt)
    g[0] = 1.0
    got = _twin(0, cs, sn, g, np.array([a], hdt), hdt(0.0), hdt(0.0), hdt)
    hcol = np.zeros(RESTART + 1, hdt)
    hcol[0] = a
    _hessenberg_column(hcol, 0, cs, sn, g, hdt(0.0))
    assert float(got["H"][0, 0]) == float(np.sqrt(a * a))
    assert float(hcol[0]) == float(np.sqrt(a ** 2))
    assert abs(float(got["H"][0, 0]) - float(hcol[0])) \
        <= np.spacing(np.float32(abs(a)))


def test_givens_dead_call_changes_nothing():
    rng = np.random.default_rng(1)
    for hdt in (np.float32, np.float64):
        cs, sn, g, h, hn = _krylov_state(rng, 5, hdt)
        got = _twin(5, cs, sn, g, h, hn, hdt(0.0), hdt, live=False)
        assert np.array_equal(got["cs"].numpy(), cs)
        assert np.array_equal(got["g"].numpy(), g)
        assert bool((got["H"] == 7.0).all())
        assert float(got["res"]) == -1.0 and int(got["iters"]) == 3
        assert not bool(got["live"])


def _three(mv_j, pc_j, mv_t, pc_t, b, restart, maxiter, rtol, blocked):
    bj = jnp.asarray(b)
    xj, itj, rj = jax_gmres(mv_j, bj, jnp.zeros_like(bj), pc_j,
                            restart=restart, maxiter=maxiter, rtol=rtol,
                            blocked=blocked)
    bt = torch.from_numpy(b)
    xh, ith, rh = gmres(mv_t, bt, torch.zeros_like(bt), pc_t,
                        restart=restart, maxiter=maxiter, rtol=rtol,
                        blocked=blocked)
    xd, itd, rd = gmres_device(mv_t, bt, torch.zeros_like(bt), pc_t, rtol,
                               restart=restart, maxiter=maxiter,
                               blocked=blocked)
    return ((np.asarray(xj), int(itj), float(rj)),
            (xh.numpy(), ith, float(rh)), (xd.numpy(), int(itd), float(rd)))


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("restart,maxiter,rtol", [
    (90, 90, 1e-2), (30, 90, 1e-6), (10, 35, 1e-8)])
def test_device_gmres_matches_jax_and_host_on_the_cylinder(blocked, restart,
                                                           maxiter, rtol):
    (mv_j, pc_j), (mv_t, pc_t), b = _banded_systems(np.float64, 500.0)
    (xj, itj, rj), (xh, ith, rh), (xd, itd, rd) = _three(
        mv_j, pc_j, mv_t, pc_t, b, restart, maxiter, rtol, blocked)
    assert itd == ith == itj > 0
    scale = np.abs(xj).max()
    assert np.abs(xd - xj).max() <= 1e-10 * scale
    assert np.abs(xd - xh).max() <= 1e-10 * scale
    assert rd == pytest.approx(rh, rel=1e-10)
    assert rd == pytest.approx(rj, rel=1e-8)


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("kind", ["spread", "near_identity", "shift"])
def test_device_gmres_matches_jax_and_host_on_dense_systems(blocked, kind):
    """Restarted solves, the blocked path's second pass taken (the near-
    identity operator) and not (the shift)."""
    (mv_j, pc_j), (mv_t, pc_t), b = _dense_systems(np.float64, kind)
    (xj, itj, rj), (xh, ith, rh), (xd, itd, rd) = _three(
        mv_j, pc_j, mv_t, pc_t, b, 20, 70, 1e-9, blocked)
    assert itd == ith == itj > 0
    scale = np.abs(xj).max()
    assert np.abs(xd - xj).max() <= 1e-10 * scale
    assert np.abs(xd - xh).max() <= 1e-10 * scale


def test_device_gmres_f32_matches_the_host():
    """At f32 the device cycle and the host's take the same decisions on
    the same products: equal iterations and x to 1e-5 of max|x|."""
    _, (mv_t, pc_t), b = _banded_systems(np.float32, 500.0)
    bt = torch.from_numpy(b)
    for blocked in (False, True):
        xh, ith, _ = gmres(mv_t, bt, torch.zeros_like(bt), pc_t, restart=90,
                           maxiter=90, rtol=1e-3, blocked=blocked)
        xd, itd, _ = gmres_device(mv_t, bt, torch.zeros_like(bt), pc_t,
                                  1e-3, restart=90, maxiter=90,
                                  blocked=blocked)
        assert int(itd) == ith > 0
        assert float((xd - xh).abs().max()) <= 1e-5 * float(xh.abs().max())


def _cylinder_solver(mixed: bool):
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.cases.casesolvers import build_space
    case, cm, u0 = bigmesh_case.build_case("cpu", 24, 10,
                                           mixed_precision=mixed)
    cfg = case.cfg
    solver = case._make_solver(build_space(cfg), cfg.main)
    u = u0 * (1.0 + 0.01 * torch.from_numpy(
        np.random.default_rng(5).standard_normal(tuple(u0.shape))))
    return solver, cm, u


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("blocked", [False, True])
def test_device_step_reads_nothing_back_and_equals_the_host_step(
        blocked, mixed, monkeypatch):
    """The cylinder case's main step (banded bsgs x6) at 24x10 from a
    perturbed free stream: the device form under _NoHostRead gives the
    host step's Krylov iterations, its residual to 1e-12 relative (the
    residual is that of the state before the update) and its new state to
    1e-12 of max|u| in f64, to 1e-6 of max|u - u0| under mixed precision
    (the f32 Krylov update rounds differently over 90 columns than over
    the cycle's)."""
    if blocked:
        monkeypatch.setattr(linear, "_BLOCKED_N_THRESHOLD", 0)
    solver, cm, u = _cylinder_solver(mixed)
    lmesh = cm.to(torch.float32) if mixed else cm
    f = lambda x: torch.tensor(x, dtype=torch.float64)
    unew_h, res_h, it_h = solver._step(cm, u, 800.0, 1e-2, lmesh=lmesh)
    # the per-mesh structures and the free-stream state exist before the
    # step runs, as before a capture
    solver._device_step(cm, u, f(800.0), f(1e-2), f(1.0), lmesh=lmesh)
    cfl, rtol, one = f(800.0), f(1e-2), f(1.0)
    with _NoHostRead():
        unew, res, it, du = solver._device_step(cm, u, cfl, rtol, one,
                                                lmesh=lmesh)
    assert int(it) == it_h > 0
    assert float(res) == pytest.approx(res_h, rel=1e-12)
    err = float((unew - unew_h).abs().max())
    if mixed:
        assert err <= 1e-6 * float((unew_h - u).abs().max())
    else:
        assert err <= 1e-12 * float(unew_h.abs().max())
    assert solver._workspace(u).key[-1] is blocked


def test_device_step_poisons_a_nan_state():
    solver, cm, u = _cylinder_solver(True)
    u = u.clone()
    u[3, 0] = float("nan")
    f = lambda x: torch.tensor(x, dtype=torch.float64)
    _, res, _, _ = solver._device_step(cm, u, f(50.0), f(1e-2), f(1.0))
    assert bool(torch.isnan(res))


@pytest.mark.parametrize("restart,maxiter,rtol", [(90, 90, 1e-2),
                                                  (10, 35, 1e-8)])
def test_device_gmres_with_an_identity_allreduce_is_the_classic_path(
        restart, maxiter, rtol):
    """allreduce = identity adds no operation to the classic path's
    arithmetic: x, the iterations and relres equal bit for bit."""
    _, (mv_t, pc_t), b = _banded_systems(np.float64, 500.0)
    bt = torch.from_numpy(b)
    runs = [gmres_device(mv_t, bt, torch.zeros_like(bt), pc_t, rtol,
                         restart=restart, maxiter=maxiter, blocked=False,
                         **kw) for kw in ({}, dict(allreduce=lambda t: t))]
    (x1, i1, r1), (x2, i2, r2) = runs
    assert int(i1) > 0
    assert torch.equal(x1, x2) and torch.equal(i1, i2) and torch.equal(r1, r2)


def test_device_gmres_with_allreduce_refuses_the_blocked_path():
    _, (mv_t, pc_t), b = _banded_systems(np.float64, 500.0)
    bt = torch.from_numpy(b)
    with pytest.raises(ValueError, match="classic path"):
        gmres_device(mv_t, bt, torch.zeros_like(bt), pc_t, 1e-2,
                     blocked=True, allreduce=lambda t: t)


@pytest.fixture(scope="module")
def gmres_pairs():
    """torch_dist_ranks.gmres_pairs on two gloo ranks."""
    from fvens_tpu_torch.dist import launch
    return launch.run(R.gmres_pairs, 2, device="cpu", threads=1, timeout=60,
                      join_timeout=300)[0]


@pytest.mark.parametrize("case", R.GMRES_CASES, ids=str)
def test_distributed_device_gmres_matches_the_host_gmres(gmres_pairs, case):
    """On two gloo ranks, the device-controlled GMRES over reduced inner
    products gives the host-controlled one's Krylov iterations and x to
    1e-12 relative (f64; only the final update's rounding differs)."""
    xh, ih, rh, xd, idv, rd = gmres_pairs[case]
    assert idv == ih > 0
    assert np.abs(xd - xh).max() <= 1e-12 * np.abs(xh).max()
    assert rd == pytest.approx(rh, rel=1e-10)
