"""The banded heat equation (1x1 blocks) through the CUDA kernels, on the
card.

Needs a CUDA card and nvcc: marked `gpu`, and each test skips when
torch.cuda.is_available() is false. Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_heat_gpu.py

The 64x64 heat problem solved with banded=True, bsgs x6 (K1 for the
matvec, K1b's cluster design for the preconditioner) equals the gather
path's solve with the same preconditioner (bsgs x6 on slot gathers, plain
PyTorch) to 1e-10 of max|u|: both run the same arithmetic in f64, summed
in another order, so the two take the same steps and Krylov iterations.
"""

import pytest
import torch

from fvens_tpu_torch.cases import model_problems as mp
from fvens_tpu_torch.solver import banded_kernels as bk
from fvens_tpu_torch.solver import rowset_kernels as rk

pytestmark = pytest.mark.gpu

N = 64
BSGS = dict(pc="bsgs", pc_sweeps=6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _solve(dev, banded: bool):
    solver, mesh = mp.heat_solver(dev, N, False, banded=banded, **BSGS)
    u0 = torch.zeros((mesh.NC, 1), dtype=torch.float64, device=dev)
    u, info = solver.solve(mesh, u0)
    return u, info, mesh


def test_banded_heat_equals_the_gather_path(cuda):
    n0, f0 = bk.banded_apply.launches, bk.bsgs_apply.launches
    c0, r0 = bk.bsgs_apply.cluster_launches, rk.row_set.launches
    u, info, mesh = _solve(cuda, True)
    torch.cuda.synchronize()
    its = info.total_lin_iters
    assert info.converged and its > 0
    # classic GMRES at 4,096 cells, one cycle a step: K1 once per Krylov
    # iteration and once for each cycle's residual, K1b once per Krylov
    # iteration (its cluster design: no band of the heat operator wraps),
    # no row_set
    assert bk.banded_apply.launches - n0 == its + info.steps
    assert bk.bsgs_apply.cluster_launches - c0 == its
    assert bk.bsgs_apply.launches == f0
    assert rk.row_set.launches == r0
    ug, ginfo, _ = _solve(cuda, False)
    assert ginfo.converged
    assert (info.steps, its) == (ginfo.steps, ginfo.total_lin_iters)
    n = mesh.n_cells
    err = float((u[:n] - ug[:n]).abs().max() / ug[:n].abs().max())
    assert err <= 1e-10, err
    assert mp.heat_error(mesh, u) == pytest.approx(mp.heat_error(mesh, ug),
                                                   rel=1e-8)
