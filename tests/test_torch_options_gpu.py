"""The solver options of the gather path on the card against their runs on
the CPU: the fixed-point block ILU0, the line smoother, the aggregation
multigrid, gmres_dr (GCRO-DR), the matrix-free matvecs, and a few main
steps of each preset of cases/bigmesh_case.OPTIONS.

Needs a CUDA card: marked `gpu`, and each test skips when
torch.cuda.is_available() is false. Imports no JAX (the CPU runs are held
to the JAX package in tests/test_torch_ilu.py, test_torch_lines_mg.py and
test_torch_krylov_options.py), so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_options_gpu.py

Tolerances, card against CPU on the same vectors (the operators built on
each from the same state, which the card's residual and Jacobian give to
rounding): operators to 1e-12 of their largest entry at f64 and 1e-5 at
f32 (the card sums in other orders), the FD shell on a unit vector to
1e-5 (its difference quotient divides the residuals' differences, 1.6e-14
of their largest entry between card and CPU, by the perturbation 1e-7); solve histories with equal Krylov iterations and residuals to
1e-9 relative with a floor of 1e-12 of the first (the FD matvec: 1e-4,
with a floor of 1e-9, as on the CPU against the JAX package). The AMG
V-cycle repeats to the bit on the card (its sums are gather-sums, not
atomics).
"""

import dataclasses

import numpy as np
import pytest
import torch

from fvens_tpu_torch.cases import bigmesh_case
from fvens_tpu_torch.cases.casesolvers import (SteadyFlowCase, build_space,
                                               initial_state)
from fvens_tpu_torch.solver import linear

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
STEPS = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _solver(dev, name, mixed=False, mesh=(32, 16)):
    """(main solver, mesh) of the cylinder case with OPTIONS[name]."""
    cfg = bigmesh_case.case_config(**bigmesh_case.OPTIONS[name])
    cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, mixed_precision=mixed))
    _, cm, _ = bigmesh_case.build_case(dev, *mesh)
    return SteadyFlowCase(cfg)._make_solver(build_space(cfg), cfg.main), cm


def _ops(dev, name, dtype):
    """The step-0 Krylov operators (matvec, pc) and a vector, at `dtype`,
    at a perturbed free stream."""
    solver, cm = _solver(dev, name, mixed=dtype == torch.float32)
    u = initial_state(solver.space, cm)
    g = np.random.default_rng(3)
    u = u * (1.0 + 0.02 * torch.from_numpy(g.standard_normal(u.shape)).to(
        dev))
    _, lrhs, ops = solver.step_operators(cm, u, 700.0)
    return solver._linear_operators(ops), lrhs


def _close(a, b, tol):
    a, b = a.cpu().double(), b.cpu().double()
    return float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["ilu0", "bline", "amg", "mf-jvp",
                                  "mf-fd"])
def test_operators_on_the_card_match_the_cpu(cuda, name, dtype):
    (mv, pc), v = _ops(cuda, name, dtype)
    (cmv, cpc), _ = _ops(torch.device("cpu"), name, dtype)
    z = pc(v)
    assert z.is_cuda and _close(z, cpc(v.cpu()), TOL[dtype])
    tol = TOL[dtype]
    if name == "mf-fd":
        # a Krylov basis vector's norm: the perturbation is then fd_eps
        z = z / torch.sqrt((z * z).sum())
        tol = max(tol, 1e-5)
    w = mv(z)
    assert w.is_cuda and w.dtype == dtype
    assert _close(w, cmv(z.cpu()), tol)


def test_amg_vcycle_repeats_to_the_bit(cuda):
    (_, pc), v = _ops(cuda, "amg", torch.float32)
    first = pc(v)
    for _ in range(3):
        assert torch.equal(pc(v), first)


def test_bline_thomas_on_the_card(cuda):
    """The line smoother where lines form (naca0012_omesh(64, 16): lines of
    32 cells), card against CPU."""
    from fvens_tpu_torch import interop
    from fvens_tpu_torch.cases.bench_case import bench_config
    from fvens_tpu_torch.mesh import compile_mesh
    from fvens_tpu_torch.mesh.meshgen import naca0012_omesh
    from fvens_tpu_torch.solver.lines import lines_from_mesh
    g = np.random.default_rng(5)
    out, D, N = {}, None, None
    for dev in (torch.device("cpu"), cuda):
        cm = compile_mesh(naca0012_omesh(64, 16), bench_config().bcs,
                          dtype=torch.float64, device=dev)
        if D is None:
            D = 4.0 * np.eye(4) + 0.5 * g.standard_normal((cm.NC, 4, 4))
            N = 0.3 * g.standard_normal((cm.NC, 4, 4, 4))
            N *= cm.nbr_mask.numpy()[:, :, None, None]
            v = g.standard_normal((cm.NC, 4))
        lines = lines_from_mesh(cm)
        assert lines.Lmax == 32
        pc = linear.make_preconditioner(
            cm, interop.jacobian_from_numpy(D, N, device=dev), "bline", 2,
            lines=lines)
        out[dev.type] = pc(torch.from_numpy(v).to(dev))
    assert _close(out["cuda"], out["cpu"], 1e-12)


def test_gmres_dr_on_the_card(cuda):
    g = np.random.default_rng(1)
    n = 96
    A = np.eye(n) * 4.0 + 0.3 * g.standard_normal((n, n))
    b = g.standard_normal(n)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        At = torch.from_numpy(A).to(dev)
        bt = torch.from_numpy(b).to(dev)
        x, it, rel, U = linear.gmres_dr(lambda v: At @ v, bt,
                                        torch.zeros_like(bt), lambda v: v,
                                        k=6, restart=12, maxiter=48,
                                        rtol=1e-10)
        x2, it2, _, _ = linear.gmres_dr(lambda v: At @ v, bt * 0.5 + 1.0,
                                        torch.zeros_like(bt), lambda v: v,
                                        U=U, k=6, restart=12, maxiter=48,
                                        rtol=1e-10)
        assert x.device.type == U.device.type == dev.type
        res[dev.type] = (x.cpu(), it, x2.cpu(), it2)
    (x, it, x2, it2), (cx, cit, cx2, cit2) = res["cuda"], res["cpu"]
    assert (it, it2) == (cit, cit2)
    assert _close(x, cx, 1e-10) and _close(x2, cx2, 1e-10)


@pytest.mark.parametrize("name", list(bigmesh_case.OPTIONS))
def test_preset_steps_on_the_card_match_the_cpu(cuda, name):
    """STEPS main steps of each preset from free stream in f64 (the
    recycling gate open from the second step), card against CPU."""
    hist = {}
    for dev in (cuda, torch.device("cpu")):
        solver, cm = _solver(dev, name)
        if name == "bsgs-recycle":
            solver.lin = dataclasses.replace(solver.lin,
                                             deflation_start_relres=10.0)
        u, info = solver.solve(cm, initial_state(solver.space, cm),
                               max_steps=STEPS)
        assert u.device.type == dev.type and bool(torch.isfinite(u).all())
        hist[dev.type] = info.history
    rtol, floor = (1e-4, 1e-9) if name == "mf-fd" else (1e-9, 1e-12)
    first = hist["cpu"][0][2]
    for h, c in zip(hist["cuda"], hist["cpu"]):
        assert h[0] == c[0] and h[4] == c[4], (h, c)
        assert abs(h[2] - c[2]) <= rtol * c[2] + floor * first, (h, c)
