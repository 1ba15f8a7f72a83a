"""The port on a CUDA card: the BSR SpGEMM, BSR SpMM and grouped GEMM
kernels against their plain versions, the ``ops`` entry point against its
CPU path, the monoC front door and tiled path against dense ``A @ B``, and
the other six models and ``model="auto"`` against their CPU path and scipy,
and every model's batched executor against its unbatched one; a session
whose K1 fails to load raises.

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
    route as k1_route,
)
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_local, route as k2_route
from repro_torch.kernels.moe_gemm import launch_plan, moe_gemm, route, split3_bf16, stage16
from repro_torch.kernels.ref import (
    bsr_spgemm_ref,
    bsr_spmm_ref,
    moe_gemm_ref,
    split3_bf16_ref,
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
     (32, 32, 32), (24, 20, 28), (8, 64, 8)],
)
def test_k1_routes_at_run_lengths(cuda, bm, bk, bn, dtype, run_len):
    """Small blocks (warp_runs), sides of 17 to 32 and bk over 16
    (tile_runs) and large blocks (mma_runs) over runs of 1, 2 and 24 pairs
    on N(0, 1) data with full fp32 mantissas: 3 x 2 C blocks, each summing
    run_len pairs, then a garbage run into a last slot."""
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
    assert kernel == ("warp_runs" if max(bm, bk, bn) <= 16 else
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
