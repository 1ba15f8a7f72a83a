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
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_local, row_offsets
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
