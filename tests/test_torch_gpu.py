"""The port on a CUDA card: the BSR SpGEMM kernel against its plain version,
and the monoC front door and tiled path against dense ``A @ B``.

Marked ``gpu``; every test skips where no CUDA device exists (decided in
the ``cuda`` fixture, never at import).  On a card:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.distributed.plan_ir import plan_monoC_from_dense
from repro_torch.distributed.spgemm_exec import monoC_spgemm, unpack_monoC_result
from repro_torch.kernels.bsr_spgemm import bsr_spgemm, bsr_spgemm_local, build_pair_lists
from repro_torch.kernels.ref import bsr_spgemm_ref
from repro_torch.sparse.bsr import to_bsr
from repro_torch.sparse.structure import from_dense, spgemm_symbolic

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _block_operands(rng, grid, block, density):
    mask = rng.random(grid) < density
    mask[0, 0] = True
    dense = rng.standard_normal((grid[0] * block, grid[1] * block)).astype(np.float32)
    return dense * np.kron(mask, np.ones((block, block), np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [1, 8, 16, 32])
def test_kernel_matches_plain_version(cuda, block, dtype):
    rng = np.random.default_rng(block)
    grid = (24, 20) if block < 32 else (8, 6)
    ab = to_bsr(_block_operands(rng, grid, block, 0.3), block, block)
    bb = to_bsr(_block_operands(rng, grid[::-1], block, 0.3), block, block)
    pa, pb, pc, crows, _ = build_pair_lists(ab.brows, ab.bcols, bb.brows, bb.bcols)
    # a trailing run of padding pairs into a garbage C slot, as monoC plans have
    zero = np.zeros((1, block, block), np.float32)
    a_blocks = torch.from_numpy(np.concatenate([ab.blocks, zero])).to(cuda, dtype)
    b_blocks = torch.from_numpy(np.concatenate([bb.blocks, zero])).to(cuda, dtype)
    pa = np.r_[pa, [len(ab.blocks)] * 7]
    pb = np.r_[pb, [len(bb.blocks)] * 7]
    pc = np.r_[pc, [len(crows)] * 7]
    n_c = len(crows) + 1
    kernel = "scalar_runs" if block == 1 else "block_runs"
    before = dict(bsr_spgemm_local.launches)
    got = bsr_spgemm(a_blocks, b_blocks, pa, pb, pc, n_c)
    torch.cuda.synchronize()
    assert bsr_spgemm_local.launches == {**before, kernel: before[kernel] + 1}
    assert got.dtype == dtype and got.device.type == "cuda"
    idx = [torch.as_tensor(x, device=cuda) for x in (pa, pb, pc)]
    want = bsr_spgemm_ref(a_blocks, b_blocks, *idx, n_c)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert not got[-1].any()


def test_front_door_on_the_card(cuda):
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((60, 50)) * (rng.random((60, 50)) < 0.1)).astype(np.float32)
    b = (rng.standard_normal((50, 40)) * (rng.random((50, 40)) < 0.1)).astype(np.float32)
    a_s, b_s = from_dense(a), from_dense(b)
    exe = repro_torch.plan(a_s, b_s, p=4, model="monoC").compile()
    assert exe.device.type == "cuda"
    before = dict(bsr_spgemm_local.launches)
    c = exe(a[a_s.coo()], b[b_s.coo()])
    assert c.device.type == "cuda"
    assert bsr_spgemm_local.launches == {**before, "scalar_runs": before["scalar_runs"] + 1}
    np.testing.assert_allclose(c.cpu().numpy(), a @ b, rtol=1e-4, atol=1e-4)


def test_tiled_path_on_the_card(cuda):
    rng = np.random.default_rng(1)
    block = 16
    a = _block_operands(rng, (8, 6), block, 0.4)
    b = _block_operands(rng, (6, 7), block, 0.4)
    plan, _ = plan_monoC_from_dense(a, b, block, 4)
    c_local = monoC_spgemm(a, b, plan, block=block)
    assert c_local.device.type == "cuda"
    c_blocks = spgemm_symbolic(
        to_bsr(a, block, block).block_structure(), to_bsr(b, block, block).block_structure()
    )
    gr, gc = c_blocks.shape
    c = unpack_monoC_result(c_local, plan, c_blocks, (gr * block, gc * block))
    np.testing.assert_allclose(
        c[: a.shape[0], : b.shape[1]].cpu().numpy(), a @ b, rtol=1e-4, atol=1e-4
    )
