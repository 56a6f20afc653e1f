"""The gather path's slot kernel (csrc/slot_gather.cu) on the card: the
bsgs apply and the 5-slot matvec against the plain twin and against the
formula the solver ran before it (linear._gather_rows, linear._slot_apply:
index_select, bmm, subtract), at f32 and f64, on the 640x320 NACA0012
O-mesh's operators (the bench physics at a perturbed free stream, the
benchmark's mesh) and on seeded Jacobians of 4x4 and 1x1 blocks on a small
hybrid mesh whose triangles' fourth slots and boundary slots are clamped,
for 0 to 6
sweeps; one apply and one matvec captured in a CUDA graph and replayed;
the launch count; and the shapes and types the kernel refuses.

Needs a CUDA card and nvcc: marked `gpu`, and each test skips when
torch.cuda.is_available() is false. Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_slot_kernel_gpu.py

Tolerances, of max|y|: 1e-13 at f64 and 1e-5 at f32 (as the banded
kernels' in test_torch_kernels_gpu.py). The kernel sums a
row's S*V products as multiply-adds slot by slot; the twin's bmm (cuBLAS)
in its own order; one rounding per product and per sum either way, and
the sweeps carry the differences on, damped by D^-1 N.
"""

import functools

import numpy as np
import pytest
import torch

import slot_meshes
from fvens_tpu_torch.cases.bench_case import bench_solver
from fvens_tpu_torch.cases.casesolvers import initial_state
from fvens_tpu_torch.solver import linear
from fvens_tpu_torch.solver import slot_kernels as sk

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
NACA = "naca0012_omesh(640, 320) operators"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@functools.lru_cache(maxsize=None)
def _operators(name: str, dtype, V: int = 4):
    """(mesh, BlockJacobian) on the card: the bench physics' gather
    operators on the 640x320 NACA0012 O-mesh at a perturbed free stream
    (f32: the mixed-precision Krylov system), or a seeded Jacobian of
    V x V blocks on slot_meshes.MESHES[name]."""
    dev = torch.device("cuda", 0)
    if name != NACA:
        m = slot_meshes.mesh(name, dev)
        return m, slot_meshes.jacobian(m, V, dtype, seed=len(name) + V)
    solver, cm = bench_solver(dev, mesh=(640, 320), banded=False,
                              mixed=dtype == torch.float32)
    u0 = initial_state(solver.space, cm)
    u0 = u0 * (1.0 + 0.01 * torch.from_numpy(
        np.random.default_rng(0).standard_normal(tuple(u0.shape))).to(dev))
    _, _, ops = solver.step_operators(cm, u0, 500.0)
    assert ops.jac.D.dtype == dtype
    return ops.mesh, ops.jac


def _formula_matvec(m, jac):
    """The matvec as the solver ran it before the kernel."""
    NC, V = jac.D.shape[0], jac.D.shape[-1]
    self_idx = torch.arange(NC, dtype=m.cell_nbrs.dtype, device=jac.D.device)
    idx = torch.cat([self_idx[:, None], linear._nbrs_in_range(m)], dim=1)
    elems = linear._row_elements(idx, V)
    op = linear._slot_operand(torch.cat([jac.D[:, None], jac.N], dim=1))
    return lambda x: linear._slot_apply(op, linear._gather_rows(
        x, elems, idx.shape))


def _formula_bsgs(m, jac, sweeps):
    """The bsgs apply as the solver ran it before the kernel."""
    Dinv = linear.block_jacobi_inverse(jac.D)
    DN = linear._slot_operand(torch.einsum("cij,ckjl->ckil", Dinv, jac.N))
    nbrs = linear._nbrs_in_range(m)
    elems = linear._row_elements(nbrs, jac.D.shape[-1])

    def pc(v):
        dv = torch.einsum("cij,cj->ci", Dinv, v)
        z = dv
        for _ in range(sweeps):
            z = dv - linear._slot_apply(DN, linear._gather_rows(
                z, elems, nbrs.shape))
        return z
    return pc


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _vector(m, dtype, seed=1, V=4):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal((m.NC, V))).to(
        m.cell_nbrs.device, dtype)


# (operators, V): the flow equations' 4x4 blocks on both, the scalar
# diffusion's 1x1 blocks on the hybrid mesh
CASES = [(name, V, role, sweeps)
         for name, V in ((NACA, 4), ("hybrid_square(9)", 4),
                         ("hybrid_square(9)", 1))
         for role, sweeps in [("matvec", 0)] + [("bsgs", s)
                                               for s in range(7)]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name,V,role,sweeps", CASES)
def test_kernel_equals_twin_and_formula(cuda, name, V, role, sweeps, dtype):
    m, jac = _operators(name, dtype, V)
    x = _vector(m, dtype, V=V)
    if role == "matvec":
        fn = linear.make_bsr_matvec(m, jac)
        want = _formula_matvec(m, jac)(x)
        twin = sk.slot_matvec_plain(fn.op.cpu(), fn.idx.cpu(), x.cpu())
    else:
        fn = linear.make_preconditioner(m, jac, "bsgs", sweeps)
        want = _formula_bsgs(m, jac, sweeps)(x)
        twin = sk.slot_bsgs_plain(fn.dinv.cpu(), fn.op.cpu(), fn.idx.cpu(),
                                  sweeps, x.cpu())
    assert isinstance(fn, sk.SlotKernel) and fn.role == role
    got = fn(x)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= TOL[dtype]
    assert _rel(got.cpu(), twin) <= TOL[dtype]


@pytest.mark.parametrize("role", ["matvec", "bsgs"])
def test_captured_and_replayed(cuda, role):
    m, jac = _operators("hybrid_square(9)", torch.float64)
    fn = (linear.make_bsr_matvec(m, jac) if role == "matvec"
          else linear.make_preconditioner(m, jac, "bsgs", 6))
    x = _vector(m, torch.float64)
    want = fn(x)
    static = x.clone()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn(static)                       # warm-up off the capture
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn(static)
    for seed in (2, 3):
        static.copy_(_vector(m, torch.float64, seed))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fn(static))
    static.copy_(x)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("role", ["matvec", "bsgs"])
def test_launches_count_one_per_call(cuda, role):
    m, jac = _operators("hybrid_square(9)", torch.float64)
    fn = (linear.make_bsr_matvec(m, jac) if role == "matvec"
          else linear.make_preconditioner(m, jac, "bsgs", 6))
    x = _vector(m, torch.float64)
    n0 = sk.SlotKernel.launches
    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    assert sk.SlotKernel.launches - n0 == 3


def _bad(kind, dev):
    m, jac = _operators("hybrid_square(9)", torch.float64)
    NC = m.NC
    nbrs = linear._nbrs_in_range(m)
    op = linear._slot_operand(jac.N)
    if kind == "float16":
        return lambda: sk.SlotKernel(op.half(), nbrs)
    if kind == "V = 3":
        return lambda: sk.SlotKernel(
            torch.zeros(NC, 3, 12, dtype=torch.float64, device=dev), nbrs)
    if kind == "matvec at S = 4":
        return lambda: sk.SlotKernel(op, nbrs)
    if kind == "bsgs at S = 5":
        return lambda: sk.SlotKernel(
            torch.zeros(NC, 4, 20, dtype=torch.float64, device=dev),
            torch.zeros(NC, 5, dtype=torch.int64, device=dev),
            dinv=jac.D, sweeps=2)
    if kind == "vector shape":
        fn = linear.make_bsr_matvec(m, jac)
        return lambda: fn(torch.zeros(NC + 1, 4, dtype=torch.float64,
                                      device=dev))
    if kind == "vector dtype":
        fn = linear.make_bsr_matvec(m, jac)
        return lambda: fn(torch.zeros(NC, 4, dtype=torch.float32,
                                      device=dev))
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["float16", "V = 3", "matvec at S = 4",
                                  "bsgs at S = 5", "vector shape",
                                  "vector dtype"])
def test_unsupported_raises(cuda, kind):
    with pytest.raises((TypeError, ValueError)):
        _bad(kind, cuda)()
