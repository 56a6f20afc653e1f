"""The gather path's slot contraction on the CPU (solver/slot_kernels.py),
where the wrapper runs its plain twin: make_preconditioner("bsgs") for 0
to 6 sweeps and make_bsr_matvec equal, bit for bit, the formula the solver
ran on every device before the CUDA kernel (linear._gather_rows,
linear._slot_apply: index_select, bmm, subtract), at V = 4 and V = 1, f32
and f64, on an O-mesh and on a hybrid mesh whose triangles' fourth slots
and boundary slots are clamped. The module imports and runs there without
nvcc (the library is built only for a CUDA tensor), counts no launch, and
refuses operands and vectors of the wrong shape. Imports no JAX.
"""

import pytest
import torch

import slot_meshes
from fvens_tpu_torch import _build
from fvens_tpu_torch.solver import linear
from fvens_tpu_torch.solver import slot_kernels as sk

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _operators(name, V, dtype):
    m = slot_meshes.mesh(name, "cpu")
    return m, slot_meshes.jacobian(m, V, dtype, seed=len(name) + V)


def _vector(m, V, dtype):
    g = torch.Generator().manual_seed(V)
    return torch.randn(m.NC, V, generator=g, dtype=torch.float64).to(dtype)


def _formula_matvec(m, jac, x):
    NC, V = jac.D.shape[0], jac.D.shape[-1]
    self_idx = torch.arange(NC, dtype=m.cell_nbrs.dtype)
    idx = torch.cat([self_idx[:, None], linear._nbrs_in_range(m)], dim=1)
    elems = linear._row_elements(idx, V)
    op = linear._slot_operand(torch.cat([jac.D[:, None], jac.N], dim=1))
    return linear._slot_apply(op, linear._gather_rows(x, elems, idx.shape))


def _formula_bsgs(m, jac, sweeps, v):
    Dinv = linear.block_jacobi_inverse(jac.D)
    DN = linear._slot_operand(torch.einsum("cij,ckjl->ckil", Dinv, jac.N))
    nbrs = linear._nbrs_in_range(m)
    elems = linear._row_elements(nbrs, jac.D.shape[-1])
    dv = torch.einsum("cij,cj->ci", Dinv, v)
    z = dv
    for _ in range(sweeps):
        z = dv - linear._slot_apply(DN, linear._gather_rows(
            z, elems, nbrs.shape))
    return z


@pytest.fixture
def no_nvcc(monkeypatch):
    """Any attempt to build a CUDA library fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA library was built for CPU tensors")
    monkeypatch.setattr(_build, "build_cuda_library", refuse)
    monkeypatch.setattr(sk, "build_cuda_library", refuse)
    monkeypatch.setattr(_build, "find_nvcc", refuse)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("V", [4, 1])
@pytest.mark.parametrize("name", sorted(slot_meshes.MESHES))
@pytest.mark.parametrize("role,sweeps",
                         [("matvec", 0)] + [("bsgs", s) for s in (0, 1, 2,
                                                                 6)])
def test_cpu_equals_the_formula_bit_for_bit(no_nvcc, name, V, dt, role,
                                            sweeps):
    dtype = DTYPES[dt]
    m, jac = _operators(name, V, dtype)
    x = _vector(m, V, dtype)
    n0 = sk.SlotKernel.launches
    if role == "matvec":
        fn = linear.make_bsr_matvec(m, jac)
        want = _formula_matvec(m, jac, x)
    else:
        fn = linear.make_preconditioner(m, jac, "bsgs", sweeps)
        want = _formula_bsgs(m, jac, sweeps, x)
    assert isinstance(fn, sk.SlotKernel) and fn.role == role
    got = fn(x)
    assert got.dtype == dtype and torch.equal(got, want)
    assert sk.SlotKernel.launches == n0


def test_the_module_imports_without_nvcc():
    import subprocess
    import sys
    code = ("import os; os.environ['PATH'] = ''; "
            "os.environ['CUDA_HOME'] = '/nonexistent'; "
            "from fvens_tpu_torch.solver import slot_kernels as sk; "
            "assert sk._LIB is None; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("kind", ["op rows", "idx rows", "dinv shape",
                                  "negative sweeps", "vector shape",
                                  "vector dtype"])
def test_cpu_refuses_wrong_shapes(kind):
    m, jac = _operators("hybrid_square(9)", 4, torch.float64)
    NC = m.NC
    nbrs = linear._nbrs_in_range(m)
    op = linear._slot_operand(jac.N)
    with pytest.raises((TypeError, ValueError)):
        if kind == "op rows":
            sk.SlotKernel(op[:, :, :12], nbrs)
        elif kind == "idx rows":
            sk.SlotKernel(op, nbrs[:-1])
        elif kind == "dinv shape":
            sk.SlotKernel(op, nbrs, dinv=jac.D[:, :3], sweeps=1)
        elif kind == "negative sweeps":
            sk.SlotKernel(op, nbrs, dinv=jac.D, sweeps=-1)
        elif kind == "vector shape":
            sk.SlotKernel(op, nbrs)(torch.zeros(NC, 3, dtype=torch.float64))
        else:
            sk.SlotKernel(op, nbrs)(torch.zeros(NC, 4, dtype=torch.float32))
