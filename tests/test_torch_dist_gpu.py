"""The distributed path on the card against the CPU.

Needs a CUDA card: marked `gpu`, and each test skips when
torch.cuda.is_available() is false. Imports no JAX (the CPU runs are held
to the JAX package in tests/test_torch_dist*.py), so it runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_dist_gpu.py

  - K1 (banded_apply) with a part's rest list added after it, and the
    seven-launch bsgs sequence with the rest list after each launch,
    against their plain twins on the same operators of each part of
    cylinder_omesh(32, 12) at D = 2 and 4: to 1e-5 of max|y| at f32 and
    1e-12 at f64, with one K1 launch per matvec (two where the part takes
    MAX_BANDS bands: the diagonal apart) and seven per apply;
  - the implicit banded step of tests/torch_dist_ranks.banded_steps (bsgs
    x4 at rtol 1e-10) in a 1-rank NCCL world (K1 and the fused K1b: one
    part has no rest list) and a 2-rank gloo world on one card
    (host-staged), each against the same world size on the CPU: equal
    Krylov iterations, res to 1e-10, u to 1e-7 relative (1e-10 absolute);
  - on one NCCL rank, the distributed step's StepProgram (the device form
    captured as a CUDA graph, its collectives inside the IF nodes'
    bodies) equal to its eager run bit for bit at two CFLs
    (tests/torch_dist_ranks.py:captured_step), with one Givens update per
    Krylov iteration, one compare-and-set launch per cycle and no
    set-condition kernel counted on the card, no NCCL kernel in its graph
    (a one-rank reduction is a clone), and an allreduce raising nothing
    under no_host_sync; the same on D = 2 and 4 NCCL ranks, one card each
    (skipped where fewer cards are visible), whose step is captured
    masked (NCCL's kernels inside an IF body crash the capture): every
    Krylov iteration runs (one Givens update each of the restart's), the
    graph holds no IF node and holds NCCL kernels, and every rank replays
    the same graph (a rank that diverged would hang its peers: the
    world's timeouts fail the test).
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from fvens_tpu_torch.dist import launch
from fvens_tpu_torch.dist.partition import partition_mesh
from fvens_tpu_torch.mesh.meshgen import cylinder_omesh
from fvens_tpu_torch.solver import banded, banded_kernels as bk

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_with_rest_matches_its_twin(cuda, D, dtype):
    bundle = partition_mesh(cylinder_omesh(32, 12), R.BCS, D)
    parts = banded.banded_structure_parts(bundle.fields["cell_nbrs"],
                                          bundle.fields["nbr_mask"])
    rng = np.random.default_rng(5)
    NC = bundle.NC
    for p in range(D):
        Dm = np.eye(4) * 4.0 + 0.1 * rng.standard_normal((NC, 4, 4))
        N = 0.2 * rng.standard_normal((NC, 4, 4, 4))
        x = rng.standard_normal((NC, 4))
        out = {}
        for dev in ("cpu", cuda):
            bl = parts.part(p, dev)
            assert bl.has_rest
            Dt, Nt, xt = (torch.as_tensor(a, dtype=dtype, device=dev)
                          for a in (Dm, N, x))
            Dinv = torch.linalg.inv(Dt)
            Bt = banded.banded_blocks(bl, Nt)
            DNbt = banded.banded_dn_blocks(bl, Dinv, Nt)
            R_ = banded.rest_blocks(bl, Nt)
            DNr = banded.rest_dn_blocks(bl, Dinv, Nt)
            k0 = bk.banded_apply.launches
            mv = bk.make_banded_matvec_kernel(Dt, Bt, bl.offsets, bl, R_)(xt)
            pc = bk.make_banded_bsgs_sequence(Dinv, DNbt, bl.offsets, 6, bl,
                                              DNr)(xt)
            if dev != "cpu":
                torch.cuda.synchronize()
                # the matvec: one launch, two with MAX_BANDS bands (the
                # diagonal apart); the sequence: D^-1 v and 6 sweeps
                mv_launches = 1 + (len(bl.offsets) >= bk.MAX_BANDS)
                assert bk.banded_apply.launches - k0 == mv_launches + 7
                plain_mv = banded.make_banded_matvec(
                    Dt, Bt, bl.offsets, bl, R_)(xt)
                plain_pc = banded.make_banded_bsgs(
                    Dinv, DNbt, bl.offsets, 6, bl, DNr)(xt)
                for got, want in ((mv, plain_mv), (pc, plain_pc)):
                    assert (got - want).abs().max() \
                        <= TOL[dtype] * want.abs().max()
            out[str(dev)] = (mv.cpu(), pc.cpu())
        for got, want in zip(out[str(cuda)], out["cpu"]):
            assert (got - want).abs().max() <= TOL[dtype] * want.abs().max()


@pytest.mark.parametrize("D,backend,device", [(1, "nccl", "cuda"),
                                              (2, "gloo", "cuda:0")])
def test_banded_step_on_the_card_matches_the_cpu(cuda, D, backend, device):
    card = launch.run(R.banded_steps, D, backend=backend, device=device,
                      timeout=60, join_timeout=600)[0]
    cpu = launch.run(R.banded_steps, D, device="cpu", threads=1, timeout=60,
                     join_timeout=600)[0]
    for banded_on in (False, True):
        u, res, it, has_bl = card[banded_on]
        cu, cres, cit, _ = cpu[banded_on]
        assert has_bl == banded_on and it == cit
        np.testing.assert_allclose(res, cres, rtol=1e-10)
        np.testing.assert_allclose(u, cu, rtol=1e-7, atol=1e-10)


def _captured_step_on(D):
    out = launch.run(R.captured_step, D, backend="nccl", device="cuda",
                     timeout=60, join_timeout=600)[0]
    assert out.pop("reduce_in_no_host_sync")
    graph, masked, m = out.pop("graph"), out.pop("masked"), out.pop("restart")
    assert "error" not in graph, graph
    assert masked is (D > 1)
    for cfl, (equal, its, res, n) in out.items():
        assert equal, cfl
        assert its > 0 and np.isfinite(res)
        assert n["givens_column"] == (m if masked else its)
        assert n["set_if"] == 0 and n["cond_set"] == 1
        assert (n["graph_if"] == 0) is masked
        # one part: K1 once a matvec; rest lists: more (the sequence)
        assert n["banded_apply"] == its + 1 if D == 1 \
            else n["banded_apply"] > its + 1
    return graph


def test_captured_distributed_step_equals_its_eager_run(cuda):
    graph = _captured_step_on(1)
    assert graph["if_bodies"] > 0 and not graph["nccl_kernels"]


@pytest.mark.parametrize("D", [2, 4])
def test_captured_distributed_step_on_separate_cards(cuda, D):
    if torch.cuda.device_count() < D:
        pytest.skip(f"needs {D} CUDA cards (one NCCL rank a card)")
    graph = _captured_step_on(D)
    assert graph["if_bodies"] == 0 and graph["nccl_kernels"].get("top", 0) > 0
