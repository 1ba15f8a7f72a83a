"""The port on a CUDA card: the BSR SpGEMM, BSR SpMM and grouped GEMM
kernels against their plain versions, the ``ops`` entry point against its
CPU path, the monoC front door and tiled path against dense ``A @ B``, and
the other six models and ``model="auto"`` against their CPU path and scipy,
and every model's batched executor against its unbatched one; the Sparse
SUMMA baseline (one K1 launch a stage) and ``spsumma``; the device
partitioner's labels on the card equal to its CPU labels; a session whose
K1 fails to load raises; the LM stack's serving path on the card against
the CPU, its K3 launches, and a decode step with an expert placement that
never waits for the card; the SSM's scan and its gradient on the card
against the CPU, Mamba and hybrid decode steps that never wait for the
card, and their smoke configs' loss and gradients against the CPU.

Marked ``gpu``; every test skips where no CUDA device exists (decided in
the ``cuda`` fixture, never at import).  On a card:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.distributed.plan_ir import moved_items, plan_monoC_from_dense
from repro_torch.distributed.spgemm_exec import monoC_spgemm, unpack_monoC_result
from repro_torch.kernels import ops
from repro_torch.kernels.bsr_spgemm import (
    bsr_spgemm,
    bsr_spgemm_local,
    build_pair_lists,
    pair_runs,
    route as k1_route,
)
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_local, route as k2_route
from repro_torch.kernels.moe_gemm import (
    GroupedGemm,
    grad_launch_plan,
    launch_plan,
    moe_gemm,
    moe_gemm_backward,
    route,
    split3_bf16,
    split3_bf16_t,
    stage16,
)
from repro_torch.kernels.ref import (
    bsr_spgemm_ref,
    bsr_spmm_ref,
    moe_gemm_grad_ref,
    moe_gemm_ref,
    split3_bf16_ref,
    split3_bf16_t_ref,
    stage16_ref,
)
from repro_torch.sparse.bsr import to_bsr
from repro_torch.sparse.structure import from_dense, spgemm_symbolic

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}


def _counted(counts: dict, before: dict, kernel: str) -> bool:
    """The counters moved by exactly one launch of ``kernel``."""
    return counts == {**before, kernel: before[kernel] + 1}


def _moe_counted(before: dict, x, w) -> bool:
    """K3's counters moved by exactly the launches ``launch_plan(x, w)`` lists."""
    moved = {k: v - before[k] for k, v in moe_gemm.launches.items() if v != before[k]}
    return moved == launch_plan(x, w)


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
    kernel = k1_route(block, block, block)
    assert kernel == {1: "scalar_runs", 8: "warp_runs", 16: "warp_runs", 32: "tile_runs"}[block]
    before = dict(bsr_spgemm_local.launches)
    got = bsr_spgemm(a_blocks, b_blocks, pa, pb, pc, n_c)
    torch.cuda.synchronize()
    assert _counted(bsr_spgemm_local.launches, before, kernel)
    assert got.dtype == dtype and got.device.type == "cuda"
    idx = [torch.as_tensor(x, device=cuda) for x in (pa, pb, pc)]
    want = bsr_spgemm_ref(a_blocks, b_blocks, *idx, n_c)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert not got[-1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "bm, bk, bn",
    [(8, 16, 8), (16, 8, 32), (4, 8, 12), (1, 8, 1), (64, 64, 64), (128, 128, 128),
     (32, 32, 32), (24, 20, 28), (8, 64, 8)],
)
def test_kernel_takes_every_block_shape(cuda, bm, bk, bn, dtype):
    """Every route on N(0, 1) blocks with full fp32 mantissas, against the
    plain version and, in fp32, float64."""
    rng = np.random.default_rng(bm * 1000 + bk * 10 + bn)
    grid = 12 if max(bm, bk, bn) < 64 else 4
    a_mask, b_mask = rng.random((2, grid, grid)) < 0.3
    a_mask[0, 0] = b_mask[0, 0] = True
    ab = to_bsr(np.kron(a_mask, np.ones((bm, bk), np.float32)), bm, bk)
    bb = to_bsr(np.kron(b_mask, np.ones((bk, bn), np.float32)), bk, bn)
    pa, pb, pc, crows, _ = build_pair_lists(ab.brows, ab.bcols, bb.brows, bb.bcols)
    a_blocks = torch.from_numpy(rng.standard_normal(ab.blocks.shape).astype(np.float32))
    b_blocks = torch.from_numpy(rng.standard_normal(bb.blocks.shape).astype(np.float32))
    a_blocks, b_blocks = a_blocks.to(cuda, dtype), b_blocks.to(cuda, dtype)
    before = dict(bsr_spgemm_local.launches)
    got = bsr_spgemm(a_blocks, b_blocks, pa, pb, pc, len(crows))
    torch.cuda.synchronize()
    assert _counted(bsr_spgemm_local.launches, before, k1_route(bm, bk, bn))
    assert got.shape == (len(crows), bm, bn) and got.dtype == dtype
    idx = [torch.as_tensor(x, device=cuda) for x in (pa, pb, pc)]
    want = bsr_spgemm_ref(a_blocks, b_blocks, *idx, len(crows))
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    if dtype == torch.float32:
        want64 = bsr_spgemm_ref(a_blocks.double(), b_blocks.double(), *idx, len(crows))
        torch.testing.assert_close(got.double(), want64, rtol=1e-4, atol=1e-4)


def _k2_kernel(bm, bk, dtype) -> str:
    """The K2 route these blocks must take: the bm = 8, bk % 8 == 0 rings,
    else the any-shape ones; 16-bit on the tensor cores."""
    ring = bm == 8 and bk % 8 == 0
    return ("warp_" if dtype == torch.float32 else "mma_") + ("rows" if ring else "blocks")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "bm, bk, n",
    [(8, 8, 256), (16, 8, 48), (4, 12, 300), (8, 40, 16), (3, 3, 256), (12, 12, 256),
     (64, 64, 64)],
)
def test_spmm_kernel_matches_plain_version(cuda, bm, bk, n, dtype):
    rng = np.random.default_rng(bm + bk + n)
    mask = rng.random((10, 7)) < 0.35
    mask[3] = False  # an empty block-row
    mask[0, 0] = True
    a = rng.standard_normal((10 * bm, 7 * bk)).astype(np.float32)
    a *= np.kron(mask, np.ones((bm, bk), np.float32))
    bsr = to_bsr(a, bm, bk)
    blocks = torch.from_numpy(bsr.blocks).to(cuda, dtype)
    dense = torch.from_numpy(rng.standard_normal((7 * bk, n)).astype(np.float32)).to(cuda, dtype)
    kernel = k2_route(bm, bk, dtype)
    assert kernel == _k2_kernel(bm, bk, dtype)
    before = dict(bsr_spmm_local.launches)
    got = bsr_spmm(blocks, bsr.brows, bsr.bcols, dense, 10, b_n=n)
    torch.cuda.synchronize()
    assert _counted(bsr_spmm_local.launches, before, kernel)
    assert got.dtype == dtype and got.shape == (10 * bm, n)
    want = bsr_spmm_ref(
        blocks, torch.as_tensor(bsr.brows, device=cuda), torch.as_tensor(bsr.bcols, device=cuda),
        dense, 10,
    )
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    assert not got[3 * bm : 4 * bm].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize(
    "bm, bk, n",
    [(8, 8, 256), (8, 8, 100), (8, 16, 136), (8, 24, 40),
     (3, 3, 256), (12, 12, 100), (16, 8, 136), (24, 12, 40), (8, 20, 256), (5, 7, 136)],
)
@pytest.mark.parametrize("dense_off", [0, 1])
def test_spmm_ring_routes_take_odd_rows_and_empty_rows(cuda, bm, bk, n, dtype, dense_off):
    """The ring routes on rows with odd and even block counts (the
    tensor-core routes pair 8-column units into k16 steps and pad an odd
    row with a zero unit), an empty block-row in the middle and one at the
    end, N off the 128-column tile and (n = 100, or a dense view one value
    into its buffer) rows the 16-byte copies cannot take: warp_rows and
    mma_rows at bm = 8, and warp_blocks and mma_blocks at bm other than 8
    (two n8 tiles at 16, two row groups at 24) and bk off 8 (block rows off
    16 bytes, and odd in 16-bit at 3 x 3 and 5 x 7)."""
    rng = np.random.default_rng(bk + n + dense_off + (bm * 1000 if bm != 8 else 0))
    counts = [1, 3, 0, 2, 5, 4, 7, 0]  # blocks per block-row
    k_blocks = 9
    mask = np.zeros((len(counts), k_blocks), bool)
    for r, c in enumerate(counts):
        mask[r, rng.choice(k_blocks, c, replace=False)] = True
    a = rng.standard_normal((bm * len(counts), bk * k_blocks)).astype(np.float32)
    a *= np.kron(mask, np.ones((bm, bk), np.float32))
    bsr = to_bsr(a, bm, bk)
    assert np.array_equal(np.bincount(bsr.brows, minlength=len(counts)), counts)
    blocks = torch.from_numpy(bsr.blocks).to(cuda, dtype)
    flat = torch.from_numpy(rng.standard_normal(bk * k_blocks * n + dense_off).astype(np.float32))
    dense = flat.to(cuda, dtype)[dense_off:].view(bk * k_blocks, n)
    kernel = k2_route(bm, bk, dtype)
    assert kernel == _k2_kernel(bm, bk, dtype)
    before = dict(bsr_spmm_local.launches)
    got = bsr_spmm(blocks, bsr.brows, bsr.bcols, dense, len(counts), b_n=n)
    torch.cuda.synchronize()
    assert _counted(bsr_spmm_local.launches, before, kernel)
    assert got.dtype == dtype and got.shape == (bm * len(counts), n)
    want = bsr_spmm_ref(
        blocks, torch.as_tensor(bsr.brows, device=cuda), torch.as_tensor(bsr.bcols, device=cuda),
        dense, len(counts),
    )
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    assert not got[2 * bm:3 * bm].any() and not got[7 * bm:].any()


def _moe_operands(rng, shape, x_dtype, w_dtype, device):
    E, C, d, f = shape
    x = torch.from_numpy(rng.standard_normal((E, C, d)).astype(np.float32)).to(device, x_dtype)
    w = torch.from_numpy(rng.standard_normal((E, d, f)).astype(np.float32) / np.sqrt(d))
    return x, w.to(device, w_dtype)


@pytest.mark.parametrize(
    "x_dtype, w_dtype",
    [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
     (torch.bfloat16, torch.float32), (torch.float16, torch.float16)],
)
# C off the 64- and 128-row grid, d off 64, f off 128 and 256; an expert
# boundary inside a 128-row box; one (E, C) slice of Qwen3-MoE's width
@pytest.mark.parametrize(
    "shape", [(2, 16, 32, 24), (3, 200, 72, 136), (2, 256, 512, 384), (5, 96, 4096, 1536)]
)
def test_moe_gemm_kernel_matches_plain_version(cuda, shape, x_dtype, w_dtype):
    E, C, d, f = shape
    x, w = _moe_operands(np.random.default_rng(C), shape, x_dtype, w_dtype, cuda)
    kernel = route(x, w)
    assert kernel == ("expert_split" if torch.float32 in (x_dtype, w_dtype) else "expert_wgmma")
    assert launch_plan(x, w) == (
        {"split3_bf16": 2, kernel: 1} if kernel == "expert_split" else {kernel: 1}
    )
    before = dict(moe_gemm.launches)
    got = moe_gemm(x, w, b_c=8, b_f=8, b_d=8)
    torch.cuda.synchronize()
    assert _moe_counted(before, x, w)
    assert got.dtype == x_dtype and got.shape == (E, C, f)
    want = moe_gemm_ref(x, w)
    tol = TOL[x_dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_moe_gemm_misaligned_view_is_staged(cuda, dtype):
    """A view one element into its buffer is 2 bytes off the 16 a tensor
    map needs: stage16 copies it to an aligned buffer, expert_wgmma takes
    that, and the answer is the same."""
    E, C, d, f = 2, 64, 128, 96
    rng = np.random.default_rng(5)
    flat = rng.standard_normal(E * C * d + 1).astype(np.float32)
    x = torch.from_numpy(flat).to(cuda, dtype)[1:].view(E, C, d)
    w = _moe_operands(rng, (E, C, d, f), dtype, dtype, cuda)[1]
    assert x.data_ptr() % 16 == 2 and route(x, w) == "expert_wgmma"
    assert launch_plan(x, w) == {"stage16": 1, "expert_wgmma": 1}
    before = dict(moe_gemm.launches)
    got = moe_gemm(x, w)
    torch.cuda.synchronize()
    assert _moe_counted(before, x, w)
    want = moe_gemm_ref(x, w)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize(
    "x_dtype, w_dtype",
    [(torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16),
     (torch.float32, torch.float32), (torch.bfloat16, torch.float32)],
)
# d off 8 (x's row pitch), f off 8 (w's and the output's), both and odd
@pytest.mark.parametrize("shape", [(3, 200, 36, 136), (2, 256, 512, 100), (2, 130, 1001, 257)])
def test_moe_gemm_takes_d_and_f_off_8(cuda, shape, x_dtype, w_dtype):
    E, C, d, f = shape
    x, w = _moe_operands(np.random.default_rng(d + f), shape, x_dtype, w_dtype, cuda)
    kernel = route(x, w)
    stages = (d % 8 != 0) + 2 * (f % 8 != 0)  # x; w and the output
    assert launch_plan(x, w) == (
        {"split3_bf16": 2, kernel: 1} if kernel == "expert_split"
        else {"stage16": stages, kernel: 1}
    )
    before = dict(moe_gemm.launches)
    got = moe_gemm(x, w, b_c=C, b_f=f, b_d=d)
    torch.cuda.synchronize()
    assert _moe_counted(before, x, w)
    assert got.dtype == x_dtype and got.shape == (E, C, f) and got.is_contiguous()
    want = moe_gemm_ref(x, w)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[x_dtype], atol=TOL[x_dtype])


def _moe_grad_counted(before: dict, x, w, dy) -> bool:
    """K3's counters moved by exactly the launches ``grad_launch_plan(x, w, dy)`` lists."""
    moved = {k: v - before[k] for k, v in moe_gemm.launches.items() if v != before[k]}
    return moved == grad_launch_plan(x, w, dy)


@pytest.mark.parametrize(
    "x_dtype, w_dtype",
    [(torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16),
     (torch.float32, torch.float32), (torch.bfloat16, torch.float32)],
)
# C, d and f off 8 and off the tiles; the training path's C = 320 on a few
# of Qwen3-MoE's experts at full width; C at every edge of the gradient
# kernels' tiles: 1 and 63 (dx's one m64n64 column tile), 160 (one n160),
# 200 and 320 (two), 640 (two column tiles of dx, and dw's dy slots read as
# a ring); d and f off 64, and an odd count of dw's 64-row tiles (d = 136)
@pytest.mark.parametrize(
    "shape", [(2, 16, 32, 24), (3, 200, 72, 136), (2, 130, 1001, 257), (4, 320, 4096, 1536),
              (3, 1, 200, 136), (2, 63, 136, 200), (3, 160, 328, 200), (2, 640, 200, 328)]
)
def test_moe_gemm_backward_matches_plain_version(cuda, shape, x_dtype, w_dtype):
    """dx = dy @ wᵀ (``expert_wgmma_dx``: w and dy read k-major, dxᵀ
    written transposed) and dw = xᵀ @ dy (``expert_wgmma_dw``: x and dy read
    MN-major) in 16-bit, the split products
    after ``split3_bf16`` and ``split3_bf16_t`` in fp32 and mixed types,
    each against ``moe_gemm_grad_ref``; the counters move by exactly what
    ``grad_launch_plan(x, w, dy)`` lists."""
    E, C, d, f = shape
    rng = np.random.default_rng(C + d)
    x, w = _moe_operands(rng, shape, x_dtype, w_dtype, cuda)
    dy = torch.from_numpy(rng.standard_normal((E, C, f)).astype(np.float32)).to(cuda, x_dtype)
    before = dict(moe_gemm.launches)
    dx, dw = moe_gemm_backward(x, w, dy)
    torch.cuda.synchronize()
    assert _moe_grad_counted(before, x, w, dy)
    plan = grad_launch_plan(x, w, dy)
    if x_dtype == w_dtype and x_dtype != torch.float32:
        assert plan["expert_wgmma_dx"] == plan["expert_wgmma_dw"] == 1
    else:
        assert plan == {"split3_bf16": 1, "split3_bf16_t": 2, "expert_split": 2}
    assert dx.dtype == x_dtype and dx.shape == (E, C, d) and dx.is_contiguous()
    assert dw.dtype == w_dtype and dw.shape == (E, d, f) and dw.is_contiguous()
    want_dx, want_dw = moe_gemm_grad_ref(x, w, dy)
    tol = TOL[x_dtype]
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=tol, atol=tol)
    # dw sums C products: hold it at the scale of its sums
    tol = TOL[w_dtype] if w_dtype == x_dtype else TOL[torch.bfloat16]
    scale = float(want_dw.float().abs().max())
    torch.testing.assert_close(dw.float(), want_dw.float(), rtol=tol, atol=tol * max(scale, 1.0))


@pytest.mark.parametrize("operand", ["x", "w", "dy"])
def test_moe_gemm_backward_takes_a_misaligned_view(cuda, operand):
    """One bf16 operand a view 2 bytes off 16-byte alignment, which
    ``stage16`` copies to an aligned buffer before the gradient kernels (as
    phase 8 serves the forward): dx and dw equal the plain version, and the
    counters move by the one stage and two products the plan lists."""
    E, C, d, f = 4, 320, 512, 384
    rng = np.random.default_rng(7)
    x, w = _moe_operands(rng, (E, C, d, f), torch.bfloat16, torch.bfloat16, cuda)
    dy = torch.from_numpy(rng.standard_normal((E, C, f)).astype(np.float32)).to(cuda).bfloat16()
    ops = {"x": x, "w": w, "dy": dy}
    buf = torch.empty(ops[operand].numel() + 1, dtype=torch.bfloat16, device=cuda)
    view = buf[1:].view(ops[operand].shape)
    view.copy_(ops[operand])
    assert view.data_ptr() % 16 == 2 and view.is_contiguous()
    ops[operand] = view
    x, w, dy = ops["x"], ops["w"], ops["dy"]
    assert grad_launch_plan(x, w, dy) == {"stage16": 1, "expert_wgmma_dx": 1, "expert_wgmma_dw": 1}
    before = dict(moe_gemm.launches)
    dx, dw = moe_gemm_backward(x, w, dy)
    torch.cuda.synchronize()
    assert _moe_grad_counted(before, x, w, dy)
    want_dx, want_dw = moe_gemm_grad_ref(x, w, dy)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=tol, atol=tol)
    scale = float(want_dw.float().abs().max())
    torch.testing.assert_close(dw.float(), want_dw.float(), rtol=tol, atol=tol * max(scale, 1.0))


def test_grouped_gemm_trains_on_the_card(cuda):
    """``GroupedGemm`` through autograd on the card equals it on the CPU (bf16
    rule), its backward launches the two gradient layouts, and a
    non-contiguous incoming gradient is copied once and counted."""
    E, C, d, f = 4, 96, 256, 128
    rng = np.random.default_rng(0)
    x, w = _moe_operands(rng, (E, C, d, f), torch.bfloat16, torch.bfloat16, cuda)
    g = torch.from_numpy(rng.standard_normal((E, f, C)).astype(np.float32)).to(cuda).bfloat16()
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        xi = x.detach().to(dev).requires_grad_()
        wi = w.detach().to(dev).requires_grad_()
        y = GroupedGemm.apply(xi, wi)
        before, copies = dict(moe_gemm.launches), GroupedGemm.dy_copies
        y.backward(g.to(dev).transpose(1, 2))  # a non-contiguous gradient
        if dev.type == "cuda":
            torch.cuda.synchronize()
            moved = {k: v - before[k] for k, v in moe_gemm.launches.items() if v != before[k]}
            assert moved == {"expert_wgmma_dx": 1, "expert_wgmma_dw": 1}
            assert GroupedGemm.dy_copies == copies + 1
        grads[dev.type] = (xi.grad.float().cpu(), wi.grad.float().cpu())
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2 * max(float(want.abs().max()), 1))


@pytest.mark.parametrize("shape, pitch", [((3, 37, 50), 40), ((2, 320, 4096), 320), ((1, 8, 8), 8)])
def test_split3_t_kernel_matches_plain_version_bit_for_bit(cuda, shape, pitch):
    x = torch.randn(shape, device=cuda) * torch.logspace(-3, 3, shape[-1], device=cuda)
    before = moe_gemm.launches["split3_bf16_t"]
    got = split3_bf16_t(x, pitch)
    assert moe_gemm.launches["split3_bf16_t"] == before + 1
    want = split3_bf16_t_ref(x.cpu(), pitch)
    assert got.shape == want.shape == (3, *shape[:-2], shape[-1], pitch)
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("cols, pitch", [(1000, 1000), (999, 1000), (1001, 1008), (1008, 1001)])
def test_stage16_matches_plain_version_bit_for_bit(cuda, dtype, cols, pitch):
    """Every start 0 to 7 values past 16-byte alignment: flat copies (same
    pitch) at each funnel shift, padded rows (zeros at the edge) and
    cropped ones; the copy's base is 16-byte aligned."""
    flat = torch.randn(7 * cols + 8, device=cuda).to(dtype)
    for off in range(8):
        x = flat[off:off + 7 * cols].view(7, cols)
        before = moe_gemm.launches["stage16"]
        got = stage16(x, pitch)
        assert moe_gemm.launches["stage16"] == before + 1
        assert got.shape == (7, pitch) and got.data_ptr() % 16 == 0
        assert torch.equal(got.view(torch.int16), stage16_ref(x, pitch).view(torch.int16))
        if pitch > cols:
            assert not got[:, cols:].any()


def _full_mantissa(rng, shape, std, device):
    """fp32 N(0, std^2) values with full 24-bit significands."""
    x = torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(device)
    assert bool((x != x.bfloat16().float()).any())  # not bf16 values
    return x


@pytest.mark.parametrize("shape", [(3, 200, 72, 136), (4, 640, 4096, 256)])
def test_expert_split_is_fp32_accurate_on_full_mantissas(cuda, shape):
    """fp32 inputs that bf16 cannot hold: a kernel that multiplied in bf16 or
    TF32 would miss 1e-4 here."""
    E, C, d, f = shape
    rng = np.random.default_rng(d)
    x = _full_mantissa(rng, (E, C, d), 1.0, cuda)
    w = _full_mantissa(rng, (E, d, f), d**-0.5, cuda)
    assert route(x, w) == "expert_split"
    before = dict(moe_gemm.launches)
    got = moe_gemm(x, w, b_c=8, b_f=8, b_d=8)
    torch.cuda.synchronize()
    assert _moe_counted(before, x, w)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, moe_gemm_ref(x, w), rtol=1e-4, atol=1e-4)
    want64 = torch.einsum("ecd,edf->ecf", x.double(), w.double())
    torch.testing.assert_close(got.double(), want64, rtol=1e-4, atol=1e-4)


def test_expert_split_sums_all_six_products(cuda):
    """At d = 64 (one k-block, so summing in the tensor cores' accumulators
    costs little) the kernel is held to the six products x_i w_j, i + j <= 2,
    of ``split3_bf16_ref``'s pieces summed in float64, within half the
    largest term of the smallest product: dropping any product misses by
    at least twice that, and so does the two-piece, three-product scheme."""
    E, C, d, f = 2, 256, 64, 256
    rng = np.random.default_rng(64)
    x = _full_mantissa(rng, (E, C, d), 1.0, cuda)
    w = _full_mantissa(rng, (E, d, f), d**-0.5, cuda)
    xs, ws = split3_bf16_ref(x).double(), split3_bf16_ref(w).double()
    terms = {(i, j): xs[i] @ ws[j] for i in range(3) for j in range(3 - i)}
    want = sum(terms.values())
    tol = min(t.abs().max().item() for t in terms.values()) / 2
    two_piece = terms[0, 0] + terms[0, 1] + terms[1, 0]
    assert (two_piece - want).abs().max().item() > tol
    assert launch_plan(x, w) == {"split3_bf16": 2, "expert_split": 1}
    before = dict(moe_gemm.launches)
    got = moe_gemm(x, w)
    torch.cuda.synchronize()
    assert _moe_counted(before, x, w)
    assert (got.double() - want).abs().max().item() < tol


def test_split3_kernel_matches_plain_version_bit_for_bit(cuda):
    rng = np.random.default_rng(3)
    sig = 1 + rng.integers(0, 2**23, 100_003) / 2**23
    vals = rng.choice([-1.0, 1.0], sig.size) * np.ldexp(sig, rng.integers(-60, 60, sig.size))
    flat = torch.from_numpy(vals.astype(np.float32)).to(cuda)
    for x in (flat, flat[1:]):  # aligned, and a view 4 bytes off (one value a thread)
        before = dict(moe_gemm.launches)
        got = split3_bf16(x)
        assert moe_gemm.launches["split3_bf16"] == before["split3_bf16"] + 1
        assert torch.equal(got, split3_bf16_ref(x))
        assert torch.equal(got.double().sum(0), x.double())


@pytest.mark.parametrize("cols, pitch", [(37, 40), (100, 104), (1001, 1008)])
def test_split3_kernel_pads_rows_bit_for_bit(cuda, cols, pitch):
    """Rows padded to a pitch of a multiple of 8 values (d or f off 8):
    zeros split into zeros, and a view 4 bytes off alignment too."""
    rng = np.random.default_rng(cols)
    flat = torch.from_numpy(rng.standard_normal(5 * cols + 1).astype(np.float32)).to(cuda)
    for x in (flat[:-1].view(5, cols), flat[1:].view(5, cols)):
        got = split3_bf16(x, pitch)
        assert got.shape == (3, 5, pitch)
        assert torch.equal(got, split3_bf16_ref(x, pitch))
        assert not got[..., cols:].any()
        assert torch.equal(got.double().sum(0)[:, :cols], x.double())


def test_expert_split_takes_a_misaligned_fp32_view(cuda):
    E, C, d, f = 2, 64, 128, 96
    rng = np.random.default_rng(6)
    flat = _full_mantissa(rng, (E * C * d + 1,), 1.0, cuda)
    x = flat[1:].view(E, C, d)
    w = _full_mantissa(rng, (E, d, f), d**-0.5, cuda)
    assert x.data_ptr() % 16 == 4 and route(x, w) == "expert_split"
    before = dict(moe_gemm.launches)
    got = moe_gemm(x, w)
    torch.cuda.synchronize()
    assert _moe_counted(before, x, w)
    torch.testing.assert_close(got, moe_gemm_ref(x, w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("run_len", [1, 2, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize(
    "bm, bk, bn",
    [(16, 16, 16), (8, 16, 8), (8, 8, 8), (64, 64, 64), (128, 64, 96), (64, 42, 70),
     (32, 32, 32), (24, 20, 28), (8, 64, 8), (1, 1, 1)],
)
def test_k1_routes_at_run_lengths(cuda, bm, bk, bn, dtype, run_len):
    """Scalars (scalar_runs), small blocks (warp_runs), sides of 17 to 32
    and bk over 16 (tile_runs) and large blocks (mma_runs) over runs of 1,
    2 and 24 pairs on N(0, 1) data with full fp32 mantissas: 3 x 2 C
    blocks, each summing run_len pairs, then a garbage run into a last
    slot.  Longer runs at 1 x 1 x 1: ``test_scalar_runs_at_run_lengths``."""
    rng = np.random.default_rng(bm + bk + bn + run_len)
    na, nb = 3 * run_len, run_len * 2
    a32 = _full_mantissa(rng, (na + 1, bm, bk), 1.0, cuda)
    b32 = _full_mantissa(rng, (nb + 1, bk, bn), 1.0, cuda)
    a32[-1], b32[-1] = 0.0, 0.0
    ai, bj = np.meshgrid(np.arange(3), np.arange(2), indexing="ij")
    k = np.arange(run_len)
    pa = (ai.ravel()[:, None] * run_len + k).ravel()  # A block (i, k)
    pb = (k * 2 + bj.ravel()[:, None]).ravel()  # B block (k, j)
    pc = np.repeat(np.arange(6), run_len)
    pa, pb, pc = np.r_[pa, [na] * 5], np.r_[pb, [nb] * 5], np.r_[pc, [6] * 5]
    a_blocks, b_blocks = a32.to(dtype), b32.to(dtype)
    kernel = k1_route(bm, bk, bn)
    assert kernel == ("scalar_runs" if bm == bk == bn == 1 else
                      "warp_runs" if max(bm, bk, bn) <= 16 else
                      "mma_runs" if max(bm, bn) > 32 else "tile_runs")
    before = dict(bsr_spgemm_local.launches)
    got = bsr_spgemm(a_blocks, b_blocks, pa, pb, pc, 7)
    torch.cuda.synchronize()
    assert _counted(bsr_spgemm_local.launches, before, kernel)
    assert got.dtype == dtype and got.shape == (7, bm, bn)
    idx = [torch.as_tensor(x, device=cuda) for x in (pa, pb, pc)]
    want = bsr_spgemm_ref(a_blocks, b_blocks, *idx, 7)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert not got[-1].any()
    if dtype == torch.float32:  # and against float64, on full mantissas
        want64 = bsr_spgemm_ref(a32.double(), b32.double(), *idx, 7)
        torch.testing.assert_close(got.double(), want64, rtol=1e-4, atol=1e-4)


# C slots of _scalar_case's runs: 0, 3, 7, 8 and 11 no run covers; 12 is the garbage run's
SCALAR_SLOTS = np.array([1, 2, 4, 5, 6, 9, 10])


def _scalar_case(rng, run_len, device, slots=SCALAR_SLOTS, n_c=13):
    """1 x 1 x 1 tables of 4,096 full-mantissa N(0, 1) values (the last
    0.0) and pair lists: a run of ``run_len`` random pairs into each of
    ``slots``, then a garbage run of 5 pairs reading the zeros into slot
    n_c - 1.  The lists as int32 tensors on ``device``."""
    a = _full_mantissa(rng, (4096, 1, 1), 1.0, device)
    b = _full_mantissa(rng, (4096, 1, 1), 1.0, device)
    a[-1], b[-1] = 0.0, 0.0
    n = run_len * len(slots)
    pa = np.r_[rng.integers(0, 4095, n), [4095] * 5]
    pb = np.r_[rng.integers(0, 4095, n), [4095] * 5]
    pc = np.r_[np.repeat(slots, run_len), [n_c - 1] * 5]
    return a, b, (pa, pb, pc), n_c


def _scalar_held(a, b, pairs, n_c, dtype, device):
    """K1 at 1 x 1 x 1 through ``bsr_spgemm``: one scalar_runs launch,
    within TOL of its plain version (and fp32 within 1e-4 of float64),
    zero in every C slot no run covers, the same bits from a second call
    and from a launch into C filled with NaN first.  Returns C."""
    from repro_torch.kernels.bsr_spgemm import launch

    a_t, b_t = a.to(dtype), b.to(dtype)
    before = dict(bsr_spgemm_local.launches)
    got = bsr_spgemm(a_t, b_t, *pairs, n_c)
    torch.cuda.synchronize()
    assert _counted(bsr_spgemm_local.launches, before, "scalar_runs")
    assert got.dtype == dtype and got.shape == (n_c, 1, 1)
    idx = [torch.as_tensor(x, device=device, dtype=torch.int32) for x in pairs]
    want = bsr_spgemm_ref(a_t, b_t, *idx, n_c)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    if dtype == torch.float32:
        want64 = bsr_spgemm_ref(a.double(), b.double(), *idx, n_c)
        torch.testing.assert_close(got.double(), want64, rtol=1e-4, atol=1e-4)
    covered = torch.zeros(n_c, dtype=torch.bool, device=device)
    covered[idx[2].long()] = True
    assert not got[~covered].any()
    assert torch.equal(bsr_spgemm(a_t, b_t, *pairs, n_c), got)
    run_start, run_c = (torch.as_tensor(x, device=device) for x in pair_runs(pairs[2]))
    out = torch.full_like(got, float("nan"))
    assert launch(a_t, b_t, *idx[:2], run_start, run_c, out) == "scalar_runs"
    torch.cuda.synchronize()
    assert torch.equal(out, got)
    return got


@pytest.mark.parametrize("run_len", [1, 31, 33, 485, 5000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_scalar_runs_at_run_lengths(cuda, dtype, run_len):
    """scalar_runs over runs shorter and longer than a warp's 32 lanes, a
    hub of MCL-facebook's size (485) and runs of 5,000 pairs that reach
    across many warps' spans, with C slots no run covers and a garbage
    run: ``_scalar_held``'s checks."""
    a, b, pairs, n_c = _scalar_case(np.random.default_rng(run_len), run_len, cuda)
    _scalar_held(a, b, pairs, n_c, dtype, cuda)


def test_scalar_runs_with_one_run_holding_every_pair(cuda):
    """300,000 pairs in one run, across every warp's span (the first warp
    owns it), into slot 1 of 3."""
    a, b, pairs, n_c = _scalar_case(np.random.default_rng(3), 300_000, cuda,
                                    slots=np.array([1]), n_c=3)
    pairs = tuple(x[:-5] for x in pairs)  # no garbage run: slot 2 is uncovered
    got = _scalar_held(a, b, pairs, n_c, torch.float32, cuda)
    assert got[0] == 0 and got[2] == 0


def test_scalar_runs_with_no_run_is_zero_and_launches_nothing(cuda):
    a = torch.ones((4, 1, 1), device=cuda)
    before = dict(bsr_spgemm_local.launches)
    got = bsr_spgemm(a, a, [], [], [], 5)
    torch.cuda.synchronize()
    assert bsr_spgemm_local.launches == before
    assert got.shape == (5, 1, 1) and not got.any()


def test_scalar_runs_sums_a_run_the_same_wherever_it_sits(cuda):
    """The pair lists of 485-pair runs twice in one launch, the second copy
    offset by its tables and C slots (as a batched monoC launch lays out its
    sets): each copy's C is the single launch's bit for bit."""
    rng = np.random.default_rng(12)
    a, b, (pa, pb, pc), n_c = _scalar_case(rng, 485, cuda)
    one = bsr_spgemm(a, b, pa, pb, pc, n_c)
    a2, b2 = torch.cat([a, a.flip(0)]), torch.cat([b, b.flip(0)])
    two = bsr_spgemm(a2, b2, np.r_[pa, 4095 - pa + 4096], np.r_[pb, 4095 - pb + 4096],
                     np.r_[pc, pc + n_c], 2 * n_c)
    torch.cuda.synchronize()
    assert torch.equal(two[:n_c], one)
    assert torch.equal(two[n_c:], one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["garbage", "hub", "mcl_facebook", "one_pair_runs",
                                  "span_edges", "uncovered"])
def test_scalar_runs_is_the_model_bit_for_bit(cuda, case, dtype):
    """``bsr_spgemm`` at 1 x 1 x 1 on the card: one ``scalar_runs`` launch
    whose C is ``k1_scalar_model.runs_own_order`` of the values it reads,
    bit for bit (rounded once to the result's type), zero in every slot no
    run covers; on the model's cases (a 1,000-pair hub, runs ending on and
    beside span and window edges, one-pair runs, long gaps of uncovered
    slots, a garbage run) and MCL-facebook at scale 0.05 squared."""
    from k1_scalar_model import CASES, mcl_facebook, runs_own_order

    a, b, pa, pb, pc, n_c = (mcl_facebook if case == "mcl_facebook" else CASES[case])()
    ta, tb = (torch.from_numpy(v).to(dtype) for v in (a, b))
    run_start, run_c = pair_runs(pc)
    want32 = runs_own_order(ta.float().numpy()[pa], tb.float().numpy()[pb], run_start, run_c,
                            n_c)
    before = dict(bsr_spgemm_local.launches)
    got = bsr_spgemm(ta.view(-1, 1, 1).to(cuda), tb.view(-1, 1, 1).to(cuda), pa, pb, pc, n_c)
    torch.cuda.synchronize()
    assert _counted(bsr_spgemm_local.launches, before, "scalar_runs")
    assert torch.equal(got.cpu().ravel(), torch.from_numpy(want32).to(dtype))


def test_expert_wgmma_is_deterministic(cuda):
    """The persistent walk sums each tile in one block, in one order, with
    no atomics: the same inputs give the same bits."""
    x, w = _moe_operands(np.random.default_rng(9), (5, 96, 4096, 1536), torch.bfloat16,
                         torch.bfloat16, cuda)
    assert route(x, w) == "expert_wgmma"
    assert torch.equal(moe_gemm(x, w), moe_gemm(x, w))


def test_ops_on_the_card_match_the_cpu(cuda):
    rng = np.random.default_rng(11)
    a = _block_operands(rng, (6, 5), 8, 0.4)
    b = _block_operands(rng, (5, 4), 8, 0.5)
    dense = rng.standard_normal((40, 128)).astype(np.float32)
    ab, bb = to_bsr(a, 8, 8), to_bsr(b, 8, 8)
    for got, want in (
        (ops.spmm(ab, dense), ops.spmm(ab, dense, device="cpu")),
        (ops.spgemm(ab, bb)[0], ops.spgemm(ab, bb, device="cpu")[0]),
    ):
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    w = rng.standard_normal((2, 64, 16)).astype(np.float32)
    got = ops.grouped_gemm(x, w)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), x @ w, rtol=1e-4, atol=1e-4)


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


@pytest.mark.parametrize("block", [16, 64])
def test_tiled_path_on_the_card(cuda, block):
    rng = np.random.default_rng(1)
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


def _scipy_product(a_s, av, b_s, bv) -> np.ndarray:
    """A @ B in float64 by scipy, from canonical CSR values."""
    import scipy.sparse as sp

    a = sp.csr_matrix((av.astype(np.float64), a_s.indices, a_s.indptr), shape=a_s.shape)
    b = sp.csr_matrix((bv.astype(np.float64), b_s.indices, b_s.indptr), shape=b_s.shape)
    return (a @ b).toarray()


@pytest.mark.parametrize(
    "model", ["rowwise", "columnwise", "outer", "fine", "monoA", "monoB", "auto"]
)
def test_every_model_on_the_card(cuda, model):
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((70, 55)) * (rng.random((70, 55)) < 0.1)).astype(np.float32)
    b = (rng.standard_normal((55, 48)) * (rng.random((55, 48)) < 0.12)).astype(np.float32)
    a_s, b_s = from_dense(a), from_dense(b)
    av, bv = a[a_s.coo()], b[b_s.coo()]
    handle = repro_torch.plan(a_s, b_s, p=4, model=model)
    exe = handle.compile()
    assert exe.device.type == "cuda"
    exe.runtime.comm.reset()
    c = exe(av, bv)
    assert c.device.type == "cuda" and c.dtype == torch.float32
    assert exe.runtime.comm.items_moved == moved_items(handle.execution_plan)
    on_cpu = handle.compile(device="cpu")(av, bv)
    np.testing.assert_allclose(c.cpu().numpy(), on_cpu.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c.cpu().numpy(), _scipy_product(a_s, av, b_s, bv),
                               rtol=1e-4, atol=1e-4)


def stacked_rowwise(plan, a_local, b_local, K: int, J: int) -> torch.Tensor:
    """The row-wise step with all p ranks' (K, J) tables stacked at once
    (as the reference's shard_map holds them): each rank's own B rows and
    the rows it receives, looked up at their owners, then one batched
    product."""
    p = plan.p
    tables = b_local.new_zeros((p, K, J))
    local = plan.local_b_rows
    for d in range(p):
        n_own = int((local[d] >= 0).sum())
        tables[d, torch.as_tensor(local[d, :n_own])] = b_local[d, :n_own]
        for s, t in zip(*np.nonzero(plan.recv_key[:, d] >= 0)):
            k = plan.recv_key[s, d, t]
            owner, slot = np.argwhere(local == k)[0]
            tables[d, k] = b_local[owner, slot]
    return torch.bmm(a_local, tables)


def test_columnwise_rank_by_rank_equals_stacked_tables(cuda):
    rng = np.random.default_rng(4)
    a = (rng.standard_normal((96, 80)) * (rng.random((96, 80)) < 0.08)).astype(np.float32)
    b = (rng.standard_normal((80, 64)) * (rng.random((80, 64)) < 0.1)).astype(np.float32)
    a_s, b_s = from_dense(a), from_dense(b)
    handle = repro_torch.plan(a_s, b_s, p=4, model="columnwise")
    exe = handle.compile()
    av, bv = (torch.from_numpy(v).to(cuda) for v in (a[a_s.coo()], b[b_s.coo()]))
    a_local, b_local = exe.runtime.pack(*exe.pack(av, bv))
    # the inner row-wise step multiplies B^T by a table of A^T rows: (K, I)
    got = exe.runtime.step(a_local, b_local)
    want = stacked_rowwise(handle.execution_plan, a_local, b_local, a.shape[1], a.shape[0])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", repro_torch.executable_models())
def test_batched_equals_looped_on_the_card(cuda, model):
    rng = np.random.default_rng(6)
    a_s = from_dense(rng.random((60, 50)) < 0.1)
    b_s = from_dense(rng.random((50, 44)) < 0.12)
    av = rng.standard_normal((3, a_s.nnz)).astype(np.float32)
    bv = rng.standard_normal((3, b_s.nnz)).astype(np.float32)
    handle = repro_torch.plan(a_s, b_s, p=4, model=model)
    one, exe = handle.compile(), handle.compile(batch=3)
    assert exe.batch_capacity == 4
    exe.runtime.comm.reset()
    got = exe(av, bv)
    assert got.device.type == "cuda" and tuple(got.shape) == (3, 60, 44)
    assert exe.runtime.comm.items_moved == 4 * moved_items(handle.execution_plan)
    for i in range(3):
        want = one(av[i], bv[i])
        if model == "monoC":  # one K1 launch, every C slot in the same order
            assert torch.equal(got[i], want), i
        else:  # CUDA index_add_ sums in no fixed order
            np.testing.assert_allclose(got[i].cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[i].cpu().numpy(),
                                   _scipy_product(a_s, av[i], b_s, bv[i]), rtol=1e-4, atol=1e-4)


def test_batched_monoC_dispatch_is_one_k1_launch(cuda):
    rng = np.random.default_rng(7)
    a_s = from_dense(rng.random((80, 64)) < 0.08)
    b_s = a_s.transpose()  # A A^T, as the normal equations
    av = rng.standard_normal((8, a_s.nnz)).astype(np.float32)
    bv = rng.standard_normal((8, b_s.nnz)).astype(np.float32)
    exe = repro_torch.plan(a_s, b_s, p=4, model="monoC").compile(batch=8)
    exe(av, bv)  # warm
    torch.cuda.synchronize()
    before = dict(bsr_spgemm_local.launches)
    for m in (8, 5, 1):
        exe(av[:m], bv[:m])
    torch.cuda.synchronize()
    assert bsr_spgemm_local.launches == {**before,
                                         "scalar_runs": before["scalar_runs"] + 3}


@pytest.mark.parametrize("p", [4, 6])
def test_summa2d_on_the_card(cuda, p):
    """One K1 launch a stage, the closed-form words through the collective,
    the product equal to the CPU path and to scipy; batched, every set bit
    for bit its unbatched result."""
    rng = np.random.default_rng(9)
    a = (rng.standard_normal((70, 55)) * (rng.random((70, 55)) < 0.1)).astype(np.float32)
    b = (rng.standard_normal((55, 48)) * (rng.random((55, 48)) < 0.12)).astype(np.float32)
    a_s, b_s = from_dense(a), from_dense(b)
    av, bv = a[a_s.coo()], b[b_s.coo()]
    handle = repro_torch.plan(a_s, b_s, p=p, model="summa2d")
    plan = handle.execution_plan
    exe = handle.compile()
    exe.runtime.comm.reset()
    before = dict(bsr_spgemm_local.launches)
    c = exe(av, bv)
    torch.cuda.synchronize()
    assert bsr_spgemm_local.launches == {
        **before, "scalar_runs": before["scalar_runs"] + plan.n_stages}
    pr, pc = plan.pr, plan.pc
    assert exe.runtime.comm.items_moved == moved_items(plan) == (
        a_s.nnz * (pc - 1) + b_s.nnz * (pr - 1))
    on_cpu = handle.compile(device="cpu")(av, bv)
    np.testing.assert_allclose(c.cpu().numpy(), on_cpu.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c.cpu().numpy(), _scipy_product(a_s, av, b_s, bv),
                               rtol=1e-4, atol=1e-4)
    stacks = (np.stack([av, 2 * av, -av]), np.stack([bv, bv, 0.5 * bv]))
    got = handle.compile(batch=3)(*stacks)
    for i in range(3):
        assert torch.equal(got[i], exe(stacks[0][i], stacks[1][i])), i


def test_spsumma_on_the_card(cuda):
    from repro_torch.distributed import spsumma

    rng = np.random.default_rng(10)
    a = (rng.standard_normal((45, 38)) * (rng.random((45, 38)) < 0.2)).astype(np.float32)
    b = (rng.standard_normal((38, 41)) * (rng.random((38, 41)) < 0.2)).astype(np.float32)
    c = spsumma(a, b, (2, 3))
    assert c.device.type == "cuda"
    np.testing.assert_allclose(c.cpu().numpy(), a @ b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("coarsen", ["auto", "device", "host"])
@pytest.mark.parametrize("model", ["rowwise", "fine"])
def test_device_engine_labels_on_the_card_equal_the_cpu(cuda, monkeypatch, model, coarsen):
    import importlib

    from repro_torch.core import build_model, SpGEMMInstance
    from repro_torch.core.partition import partition
    from repro_torch.sparse.structure import random_structure

    monkeypatch.setattr(importlib.import_module("repro_torch.core.partition"),
                        "DEVICE_MIN_VERTICES", 0)
    rng = np.random.default_rng(0)
    inst = SpGEMMInstance(random_structure(900, 700, 0.01, rng),
                          random_structure(700, 800, 0.01, rng))
    hg = build_model(inst, model)
    for p in (2, 4, 8):
        on_card = partition(hg, p, eps=0.10, seed=0, engine="device", coarsen=coarsen)
        on_cpu = partition(hg, p, eps=0.10, seed=0, engine="device", coarsen=coarsen,
                           device="cpu")
        assert on_card.phases is not None and on_card.descend == on_cpu.descend
        np.testing.assert_array_equal(on_card.parts, on_cpu.parts)


def test_session_raises_when_k1_fails_to_load(cuda, monkeypatch):
    """A K1 library that does not load fails the multiply: the session
    raises ``KernelError`` and never answers with a model downgrade."""
    from repro_torch.kernels import KernelError, _build
    from repro_torch.kernels import bsr_spgemm as k1

    monkeypatch.setattr(k1, "_kernel", lambda: _build.load("bsr_spgemm_absent").repro_bsr_spgemm)
    rng = np.random.default_rng(8)
    a_s = from_dense(rng.random((40, 36)) < 0.1)
    av = rng.standard_normal(a_s.nnz).astype(np.float32)
    s = repro_torch.session(p=4, model="monoC")
    with pytest.raises(KernelError, match="bsr_spgemm_absent"):
        s.multiply((a_s, av), (a_s.transpose(), av))
    assert [e.kind for e in s.events] == ["cold_replan"]


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["starcoder2-15b", "internlm2-1.8b", "phi3-mini-3.8b",
                                  "command-r-35b", "llava-next-34b", "qwen3-moe-235b-a22b",
                                  "dbrx-132b", "musicgen-large", "falcon-mamba-7b",
                                  "hymba-1.5b"])
def test_lm_serving_on_the_card_equals_the_cpu(cuda, arch):
    """``forward``, ``prefill_step`` and three greedy ``decode_step``s of the
    smoke config in fp32, on the card and on the CPU with the same weights,
    within 1e-4; the MoE configs' expert products launch K3."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import forward, init_params
    from repro_torch.training import make_decode_step, make_prefill_step

    cfg = get_smoke_config(arch)
    cpu_params = init_params(cfg, 0, device="cpu")
    params = _to(cpu_params, cuda)
    rng = np.random.default_rng(0)
    n_front = 16 if cfg.frontend == "vision" else 0
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 64 - n_front)).astype(np.int32)}
    if n_front:
        batch["frontend_embeds"] = rng.standard_normal((2, n_front, cfg.d_model)).astype(np.float32)
    before = dict(moe_gemm.launches)
    close = lambda got, want: torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)  # noqa: E731
    for got, want in zip(forward(params, cfg, batch), forward(cpu_params, cfg, batch)):
        close(got, want)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    (logits, cache), (cpu_logits, cpu_cache) = prefill(params, batch), prefill(cpu_params, batch)
    close(logits, cpu_logits)
    for _ in range(3):
        tok = cpu_logits.argmax(-1)[:, None]
        logits, cache = decode(params, cache, tok)
        cpu_logits, cpu_cache = decode(cpu_params, cpu_cache, tok)
        close(logits, cpu_logits)
    for k in cpu_cache:
        close(cache[k], cpu_cache[k])
    launches = sum(v - before[k] for k, v in moe_gemm.launches.items() if k == "expert_split")
    # fp32 experts take expert_split: three products a layer in each of five calls
    assert launches == (3 * cfg.n_layers * 5 if cfg.moe else 0)


@pytest.mark.parametrize("tokens", [(8, 1), (8, 1024)])
def test_moe_layer_k3_launches_match_the_plain_version(cuda, monkeypatch, tokens):
    """The MoE layer at Qwen3-MoE's routing (128 experts, top 8) and
    narrowed widths, in bf16: B x S tokens give C = 1 (decode) and C = 640
    (prefill); each of its three K3 calls launches ``expert_wgmma`` once and
    matches ``moe_gemm_ref`` on the same inputs."""
    import dataclasses

    import repro_torch.kernels.moe_gemm as k3
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models import layers
    from repro_torch.models.transformer import layer_slices

    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").scaled_down(
        d_model=256, dtype="bfloat16"), n_layers=1)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=128, top_k=8, d_ff_expert=192))
    calls = []

    def spy(x, w, b_c=128, b_f=128, b_d=512):
        before = dict(moe_gemm.launches)
        out = moe_gemm(x, w, b_c, b_f, b_d)
        calls.append((x, w, out, {k: v - before[k] for k, v in moe_gemm.launches.items()
                                  if v != before[k]}))
        return out

    monkeypatch.setattr(k3, "moe_gemm", spy)
    lp = layer_slices(init_params(cfg, 0, device=cuda))[0]["moe"]
    x = torch.randn((*tokens, 256), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda).bfloat16()
    out, _ = layers.moe_layer(lp, x, cfg)
    assert out.shape == x.shape and bool(out.isfinite().all())
    cap = 1 if tokens[1] == 1 else 640
    assert [tuple(c[0].shape) for c in calls] == [(128, cap, 256)] * 2 + [(128, cap, 192)]
    for xi, wi, got, moved in calls:
        assert moved == {"expert_wgmma": 1}
        torch.testing.assert_close(got.float(), moe_gemm_ref(xi, wi).float(),
                                   rtol=2e-2, atol=2e-2)


def test_decode_step_with_a_placement_never_waits_for_the_card(cuda):
    """A bf16 decode step of the Qwen3-MoE smoke config with an expert
    placement installed runs under ``torch.cuda.set_sync_debug_mode("error")``
    after a warm-up step: no operation of the step (the placement's index
    tensor included) makes the host wait for the card, and its expert
    products launch K3 three times a layer."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.training import make_decode_step, make_prefill_step

    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    E = cfg.moe.n_experts
    placement = tuple(int(e) for e in np.random.default_rng(0).permutation(E))
    assert placement != tuple(range(E))
    cfg = dataclasses.replace(cfg, dtype="bfloat16", moe=dataclasses.replace(
        cfg.moe, expert_placement=placement))
    params = init_params(cfg, 0, device=cuda)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 32)),
                             device=cuda)
    logits, cache = make_prefill_step(cfg)(params, {"tokens": tokens})
    decode = make_decode_step(cfg)
    logits, cache = decode(params, cache, logits.argmax(-1)[:, None])  # warm-up
    tok = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    cap = int(np.ceil(2 * cfg.moe.top_k / E * cfg.moe.capacity_factor))
    x = torch.zeros((E, cap, cfg.d_model), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((E, cfg.d_model, cfg.moe.d_ff_expert), dtype=torch.bfloat16, device=cuda)
    want = {k: 3 * cfg.n_layers * v for k, v in launch_plan(x, w).items()}
    before = dict(moe_gemm.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = decode(params, cache, tok)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    moved = {k: v - before[k] for k, v in moe_gemm.launches.items() if v != before[k]}
    assert moved == want
    assert logits.shape == (2, cfg.vocab) and bool(logits.isfinite().all())
    assert int(cache["pos"]) == 34


def test_scan_and_its_gradient_on_the_card_equal_the_cpu(cuda):
    """``mamba_scan`` (``LinearScan``) at decays of falcon-mamba's range and
    its three gradients, card against CPU on the same inputs, fp32 within
    1e-5 (relative and absolute)."""
    from repro_torch.models.layers import mamba_scan

    g = torch.Generator().manual_seed(0)
    B, S, Di, N = 2, 256, 64, 16
    dt = torch.rand((B, S, Di, 1), generator=g) * 0.99 + 0.01
    a = torch.exp(dt * -torch.arange(1, N + 1, dtype=torch.float32))
    bx, w = (torch.randn((B, S, Di, N), generator=g) for _ in range(2))
    h0 = torch.randn((B, Di, N), generator=g)
    out = {}
    for dev in ("cpu", cuda):
        ins = [t.to(dev).requires_grad_() for t in (a, bx, h0)]
        h_all, h_last = mamba_scan(*ins, chunk=64)
        loss = (h_all * w.to(dev)).sum() + h_last.sum()
        out[str(dev)] = (h_all, h_last, *torch.autograd.grad(loss, ins))
    for got, want in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_decode_step_never_waits_for_the_card(cuda, arch):
    """A bf16 decode step of the Mamba and the hybrid smoke configs runs
    under ``torch.cuda.set_sync_debug_mode("error")`` after a warm-up
    step, updating the cache's conv tail and state in place."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.training import make_decode_step, make_prefill_step

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    params = init_params(cfg, 0, device=cuda)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 64)),
                             device=cuda)
    logits, cache = make_prefill_step(cfg)(params, {"tokens": tokens})
    decode = make_decode_step(cfg)
    logits, cache = decode(params, cache, logits.argmax(-1)[:, None])  # warm-up
    tok = logits.argmax(-1)[:, None]
    state, conv = cache["h"], cache["conv"]
    before = state.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = decode(params, cache, tok)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cache["h"] is state and cache["conv"] is conv and not torch.equal(state, before)
    assert bool(logits.isfinite().all()) and int(cache["pos"]) == 66


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_train_loss_and_gradients_on_the_card_equal_the_cpu(cuda, arch):
    """``train_loss`` and every gradient leaf of the smoke config in fp32,
    card against CPU with the same weights, within 1e-4 (relative and
    absolute; each gradient's absolute part scaled to min(1, its largest
    value), as ``chip_smoke.grad_err_within``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, train_loss
    from repro_torch.training.optimizer import tree_leaves, tree_map

    cfg = get_smoke_config(arch)
    cpu_params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32) for k in ("tokens", "labels")}
    results = []
    for params in (cpu_params, _to(cpu_params, cuda)):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = train_loss(leaves, cfg, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        results.append((loss, [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]))
    (loss_c, grads_c), (loss_g, grads_g) = results
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-4, atol=1e-4)
    assert float(sum(g.square().sum() for g in grads_c)) > 0
    for got, want in zip(grads_g, grads_c):
        scale = min(1.0, float(want.abs().max()))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * scale)
