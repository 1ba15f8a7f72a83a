"""The port's BSR x dense SpMM (``repro_torch.kernels.ops.spmm`` and
``kernels.bsr_spmm``) on the CPU, held against the JAX package's
``ops.spmm`` (its Pallas kernel in interpret mode) and its oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.bsr_spmm import bsr_spmm as jax_bsr_spmm
from repro.sparse.bsr import BlockSparse as JaxBlockSparse
from repro_torch.kernels import ops
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_local, route, row_offsets
from repro_torch.sparse.bsr import BlockSparse, to_bsr


def _random_block_dense(rng, m, k, density, bm, bk):
    """Dense matrix whose nonzero support is (bm, bk)-block-structured."""
    mask = rng.random((m // bm, k // bk)) < density
    if not mask.any():
        mask[0, 0] = True
    dense = rng.standard_normal((m, k)).astype(np.float32)
    return dense * np.kron(mask, np.ones((bm, bk), bool))


def _both(bsr: BlockSparse) -> JaxBlockSparse:
    return JaxBlockSparse(bsr.blocks, bsr.brows, bsr.bcols, bsr.shape)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# the shapes and tolerances of tests/test_kernels.py's spmm test
@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("mn", [(32, 32, 16), (64, 32, 64)])
def test_spmm_matches_jax(block, dtype, mn):
    m, k, n = mn
    rng = np.random.default_rng(0)
    a = _random_block_dense(rng, m, k, 0.4, block, block).astype(dtype)
    b = rng.standard_normal((k, n)).astype(dtype)
    bsr = to_bsr(np.asarray(a, np.float32), block, block)
    bsr = BlockSparse(bsr.blocks.astype(dtype), bsr.brows, bsr.bcols, bsr.shape)
    got = ops.spmm(bsr, b, device="cpu")
    assert got.shape == (m, n)
    assert got.dtype == (torch.float32 if dtype == np.float32 else torch.bfloat16)
    tol = 1e-5 if dtype == np.float32 else 3e-2
    want_kernel = jax_ops.spmm(_both(bsr), b, interpret=True)
    want_ref = jax_ops.bsr_spmm_ref(
        jnp.asarray(bsr.blocks), jnp.asarray(bsr.brows), jnp.asarray(bsr.bcols),
        jnp.asarray(b), m // block,
    )
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    # the plain version alone, on the unpadded block list
    plain = ops.bsr_spmm_ref(
        ops.as_tensor(bsr.blocks, "cpu"), torch.as_tensor(bsr.brows),
        torch.as_tensor(bsr.bcols), ops.as_tensor(b, "cpu"), m // block,
    )
    np.testing.assert_allclose(_f32(plain), _f32(want_ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("bm, bk", [(8, 16), (16, 8), (4, 8)])
def test_spmm_rectangular_blocks_match_jax(bm, bk):
    rng = np.random.default_rng(5)
    a = _random_block_dense(rng, 64, 64, 0.35, bm, bk)
    b = rng.standard_normal((64, 32)).astype(np.float32)
    bsr = to_bsr(a, bm, bk)
    got = ops.spmm(bsr, b, device="cpu")
    want = jax_ops.spmm(_both(bsr), b, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-4, atol=1e-4)


def test_empty_block_rows_come_out_zero():
    """The port's wrapper takes block-rows with no blocks (the JAX kernel
    needs ops.spmm's zero padding for them); both ops agree."""
    rng = np.random.default_rng(2)
    a = _random_block_dense(rng, 48, 32, 0.5, 8, 8)
    a[8:24] = 0.0  # block-rows 1 and 2 empty
    b = rng.standard_normal((32, 16)).astype(np.float32)
    bsr = to_bsr(a, 8, 8)
    assert not np.isin([1, 2], bsr.brows).any()
    got = bsr_spmm(torch.from_numpy(bsr.blocks), bsr.brows, bsr.bcols, torch.from_numpy(b), 6)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-5, atol=1e-5)
    assert not got[8:24].any()
    via_ops = ops.spmm(bsr, b, device="cpu")
    want = jax_ops.spmm(_both(bsr), b, interpret=True)
    np.testing.assert_allclose(via_ops.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


@pytest.mark.parametrize("n, b_n", [(48, 32), (96, 64)])
def test_b_n_must_divide_n_in_both_packages(n, b_n):
    rng = np.random.default_rng(3)
    bsr = to_bsr(_random_block_dense(rng, 16, 16, 0.6, 8, 8), 8, 8)
    dense = rng.standard_normal((16, n)).astype(np.float32)
    with pytest.raises(ValueError, match="not divisible"):
        jax_bsr_spmm(
            jnp.asarray(bsr.blocks), jnp.asarray(bsr.brows), jnp.asarray(bsr.bcols),
            jnp.asarray(dense), m_blocks=2, b_n=b_n, interpret=True,
        )
    with pytest.raises(ValueError, match="not divisible"):
        bsr_spmm(torch.from_numpy(bsr.blocks), bsr.brows, bsr.bcols,
                 torch.from_numpy(dense), 2, b_n=b_n)
    # b_n = min(b_n, N): a tile wider than N is clipped, in both
    wide = 2 * n
    got = bsr_spmm(torch.from_numpy(bsr.blocks), bsr.brows, bsr.bcols,
                   torch.from_numpy(dense), 2, b_n=wide)
    want = jax_bsr_spmm(
        jnp.asarray(bsr.blocks), jnp.asarray(bsr.brows), jnp.asarray(bsr.bcols),
        jnp.asarray(dense), m_blocks=2, b_n=wide, interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_unsorted_or_out_of_range_indices_raise():
    rng = np.random.default_rng(4)
    bsr = to_bsr(_random_block_dense(rng, 24, 16, 1.0, 8, 8), 8, 8)
    blocks, dense = torch.from_numpy(bsr.blocks), torch.randn(16, 8)
    with pytest.raises(ValueError, match="sorted"):
        bsr_spmm(blocks, bsr.brows[::-1].copy(), bsr.bcols, dense, 3)
    with pytest.raises(ValueError, match="brows"):
        bsr_spmm(blocks, bsr.brows, bsr.bcols, dense, 2)
    with pytest.raises(ValueError, match="bcols"):
        bsr_spmm(blocks, bsr.brows, bsr.bcols + 2, dense, 3)
    with pytest.raises(ValueError, match="K=12"):
        bsr_spmm(blocks, bsr.brows, bsr.bcols, torch.randn(12, 8), 3)


def test_row_offsets():
    np.testing.assert_array_equal(row_offsets([0, 0, 2, 3, 3], 5), [0, 2, 2, 3, 5, 5])
    np.testing.assert_array_equal(row_offsets([], 2), [0, 0, 0])
    assert row_offsets([1], 2).dtype == np.int32


@pytest.mark.parametrize(
    "blocks_dtype, dense_dtype", [(jnp.bfloat16, np.float32), (np.float32, jnp.bfloat16)]
)
def test_mixed_dtypes_promote_like_jax(blocks_dtype, dense_dtype):
    rng = np.random.default_rng(6)
    bsr = to_bsr(_random_block_dense(rng, 32, 32, 0.5, 8, 8), 8, 8)
    bsr = BlockSparse(bsr.blocks.astype(blocks_dtype), bsr.brows, bsr.bcols, bsr.shape)
    dense = rng.standard_normal((32, 16)).astype(dense_dtype)
    got = ops.spmm(bsr, dense, device="cpu")
    want = jax_ops.spmm(_both(bsr), dense, interpret=True)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype) == "float32"
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


def test_spmm_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bsr = to_bsr(np.eye(8, dtype=np.float32), 8, 8)
    before = dict(bsr_spmm_local.launches)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.spmm(bsr, np.ones((8, 4), np.float32))
    np.testing.assert_array_equal(ops.spmm(bsr, np.ones((8, 4), np.float32), device="cpu"), 1)
    assert bsr_spmm_local.launches == before  # the CPU path launches no kernel


# the kernel bsr_spmm_local launches on the card, by block shape and result type
@pytest.mark.parametrize(
    "bm, bk, dtype, kernel",
    [
        (8, 8, torch.bfloat16, "mma_rows"),  # the AMG SpMM's blocks
        (8, 8, torch.float16, "mma_rows"),
        (8, 16, torch.bfloat16, "mma_rows"),
        (8, 40, torch.float16, "mma_rows"),
        (8, 8, torch.float32, "warp_rows"),
        (8, 24, torch.float32, "warp_rows"),
        (16, 8, torch.bfloat16, "mma_blocks"),  # bm other than 8
        (4, 8, torch.float32, "warp_blocks"),
        (8, 12, torch.bfloat16, "mma_blocks"),  # bk off a multiple of 8
        (8, 4, torch.float32, "warp_blocks"),
        (12, 12, torch.float32, "warp_blocks"),
        (64, 64, torch.float32, "warp_blocks"),
        (128, 128, torch.bfloat16, "mma_blocks"),
    ],
)
def test_route_picks_the_kernel_before_launch(bm, bk, dtype, kernel):
    assert route(bm, bk, dtype) == kernel


def _paired_k16(blocks, brows, bcols, dense, m_blocks):
    """The tensor-core routes' order of summation (mma_rows, mma_blocks) in
    plain PyTorch: a block-row's k8 units (8 columns of a block, with their
    8 dense rows; a block with bk off a multiple of 8 has ceil(bk / 8)
    units, the last one's columns and rows past bk zero) in order, paired
    into k16 steps, the last one of an odd row with a zero half; each
    step's 16 products summed in fp32 and added to the row's fp32 sum,
    which is rounded once.  Rows with no blocks are zero."""
    nb, bm, bk = blocks.shape
    N = dense.shape[1]
    out_dtype = torch.promote_types(blocks.dtype, dense.dtype)
    cpb = -(-bk // 8)  # k8 units a block
    pad = 8 * cpb - bk
    a = torch.nn.functional.pad(blocks.float(), (0, pad))  # (nb, bm, 8 cpb)
    a = a.reshape(nb, bm, cpb, 8).permute(0, 2, 1, 3)  # (nb, unit, bm, 8)
    tiles = torch.nn.functional.pad(dense.float().reshape(-1, bk, N), (0, 0, 0, pad))
    d = tiles.reshape(-1, cpb, 8, N)  # (block column, unit, 8, N)
    out = torch.zeros((m_blocks, bm, N))
    brows = torch.as_tensor(brows)
    for r in range(m_blocks):
        units = [(a[i, c], d[int(bcols[i]), c])
                 for i in torch.nonzero(brows == r).ravel().tolist() for c in range(cpb)]
        if len(units) % 2:
            units.append((torch.zeros(bm, 8), torch.zeros(8, N)))
        for (a0, d0), (a1, d1) in zip(units[::2], units[1::2]):
            out[r] += torch.cat([a0, a1], 1) @ torch.cat([d0, d1], 0)  # one k16 step
    return out.reshape(m_blocks * bm, N).to(out_dtype)


def _check_unit_order(bm, bk, dtype, counts, seed):
    """Blocks of (bm, bk) with ``counts`` blocks per block-row (odd, even
    and empty rows) times a (K, 24) dense block: the plain model of the
    tensor-core order (``_paired_k16``) against the JAX kernel in interpret
    mode (which ops.spmm pads with zero blocks) and float64, and the port's
    plain version against both.  fp32: within 1e-5 of both.  bf16: the
    model sums the exact products in fp32 and rounds once, so it is within
    1e-5 of float64 before that rounding and half a bf16 ulp (2^-8
    relative) after it; the JAX kernel rounds its running sum to bf16 after
    each block product, so it may differ from the model by up to the row's
    block count plus one half-ulps of the largest partial sum, bounded by
    |A| @ |dense|."""
    rng = np.random.default_rng(seed)
    k_blocks = 7
    mask = np.zeros((len(counts), k_blocks), bool)
    for r, c in enumerate(counts):
        mask[r, rng.choice(k_blocks, c, replace=False)] = True
    a = rng.standard_normal((bm * len(counts), k_blocks * bk)).astype(np.float32)
    a *= np.kron(mask, np.ones((bm, bk), np.float32))
    b = rng.standard_normal((k_blocks * bk, 24)).astype(dtype)
    bsr = to_bsr(a, bm, bk)
    bsr = BlockSparse(bsr.blocks.astype(dtype), bsr.brows, bsr.bcols, bsr.shape)
    assert np.array_equal(np.bincount(bsr.brows, minlength=len(counts)), counts)
    blocks, dense = ops.as_tensor(bsr.blocks, "cpu"), ops.as_tensor(b, "cpu")
    got = _paired_k16(blocks, bsr.brows, bsr.bcols, dense, len(counts))
    want = _f32(jax_ops.spmm(_both(bsr), b, interpret=True))
    for r in np.flatnonzero(np.asarray(counts) == 0):
        np.testing.assert_array_equal(_f32(got)[bm * r:bm * r + bm], 0)
    a64 = np.zeros((bm * len(counts), k_blocks * bk))
    for blk, r, c in zip(np.asarray(_f32(blocks), np.float64), bsr.brows, bsr.bcols):
        a64[bm * r:bm * r + bm, bk * c:bk * c + bk] = blk
    d64 = np.asarray(_f32(dense), np.float64)
    want64 = a64 @ d64
    if dtype == np.float32:
        np.testing.assert_allclose(_f32(got), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_f32(got), want64, rtol=1e-5, atol=1e-5)
    else:
        unrounded = _paired_k16(blocks.float(), bsr.brows, bsr.bcols, dense.float(), len(counts))
        np.testing.assert_allclose(unrounded.numpy(), want64, rtol=1e-5, atol=1e-5)
        assert (np.abs(_f32(got) - want64) <= 2.0**-8 * np.abs(want64) + 1e-5).all()
        slack = (np.repeat(counts, bm)[:, None] + 1) * 2.0**-8 * (np.abs(a64) @ np.abs(d64))
        assert (np.abs(_f32(got) - want) <= slack + 1e-5).all()
    # and the port's plain version, in the kernel's other order, agrees (in
    # bf16 the two fp32 sums may round to neighbours: one ulp, 2^-7)
    plain = bsr_spmm(blocks, bsr.brows, bsr.bcols, dense, len(counts))
    tol = 1e-5 if dtype == np.float32 else 2.0**-7
    np.testing.assert_allclose(_f32(plain), _f32(got), rtol=tol, atol=1e-5)
    # the port's entry point on the CPU runs the same plain version
    np.testing.assert_array_equal(_f32(ops.spmm(bsr, b, device="cpu")), _f32(plain))


@pytest.mark.parametrize("bk", [8, 16, 24])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_paired_k16_order_matches_jax(bk, dtype):
    """mma_rows's order (bm = 8, bk a multiple of 8), with odd block counts
    (a zero half in the last k16 step) and empty block-rows, held to JAX in
    interpret mode and float64 (tolerances: ``_check_unit_order``)."""
    _check_unit_order(8, bk, dtype, [1, 3, 0, 2, 5, 0, 4], seed=bk)


# the block shapes warp_blocks and mma_blocks take on the card: 3 x 3
# elasticity, 12 x 12, bm = 16 (two n8 tiles), bm = 24 (two groups of rows,
# the second half empty) and bk off a multiple of 8
@pytest.mark.parametrize("bm, bk", [(3, 3), (12, 12), (16, 8), (24, 12), (8, 20)])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_any_block_shape_matches_jax(bm, bk, dtype):
    """The k8 units of blocks of any shape, zero-filled past bk, in the
    tensor-core order, and the port's plain version (what a CPU tensor
    runs), on rows with odd and even block counts and empty rows, against
    the JAX kernel in interpret mode and float64."""
    _check_unit_order(bm, bk, dtype, [1, 3, 0, 2, 5, 0, 4, 7], seed=bm * 100 + bk)
