"""The BSR SpGEMM kernel's plain version and its wrapper on the CPU, held
against the JAX package's oracle and its Pallas kernel in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.bsr_spgemm import bsr_spgemm as jax_bsr_spgemm
from repro.kernels.ref import bsr_spgemm_ref as jax_ref
from repro.sparse.bsr import BlockSparse as JaxBlockSparse
from repro_torch.kernels import ops
from repro_torch.kernels.bsr_spgemm import (
    KERNELS,
    bsr_spgemm,
    bsr_spgemm_local,
    build_pair_lists,
    pair_runs,
    route,
)
from repro_torch.kernels.ref import bsr_spgemm_ref
from repro_torch.sparse.bsr import bsr_to_dense, to_bsr, BlockSparse


def _random_block_dense(rng, m, k, density, block):
    """Dense matrix whose nonzero support is block-structured."""
    gm, gk = m // block, k // block
    mask = rng.random((gm, gk)) < density
    if not mask.any():
        mask[0, 0] = True
    dense = rng.standard_normal((m, k)).astype(np.float32)
    return dense * np.kron(mask, np.ones((block, block), bool))


def _jax_bsr(bsr: BlockSparse) -> JaxBlockSparse:
    return JaxBlockSparse(bsr.blocks, bsr.brows, bsr.bcols, bsr.shape)


def _case(block, shape, garbage_run=False, seed=1):
    """Blocks and pair lists of a seeded random product; with
    ``garbage_run`` a trailing run of padding pairs multiplies appended
    all-zero blocks into an extra C slot, as a monoC plan's padding does."""
    m, k, n = shape
    rng = np.random.default_rng(seed)
    a = _random_block_dense(rng, m, k, 0.5, block)
    b = _random_block_dense(rng, k, n, 0.5, block)
    ab, bb = to_bsr(a, block, block), to_bsr(b, block, block)
    pa, pb, pc, crows, ccols = build_pair_lists(ab.brows, ab.bcols, bb.brows, bb.bcols)
    a_blocks, b_blocks, n_c = ab.blocks, bb.blocks, len(crows)
    if garbage_run:
        zero = np.zeros((1, block, block), np.float32)
        a_blocks, b_blocks = np.concatenate([a_blocks, zero]), np.concatenate([b_blocks, zero])
        pad = 5
        pa = np.r_[pa, np.full(pad, len(a_blocks) - 1)]
        pb = np.r_[pb, np.full(pad, len(b_blocks) - 1)]
        pc = np.r_[pc, np.full(pad, n_c)]
        n_c += 1
    return a, b, a_blocks, b_blocks, (pa, pb, pc), n_c, (crows, ccols)


@pytest.mark.parametrize("garbage_run", [False, True])
@pytest.mark.parametrize("shape", [(32, 16, 48), (48, 48, 48)])
@pytest.mark.parametrize("block", [1, 8, 16])
def test_ref_and_wrapper_match_jax_fp32(block, shape, garbage_run):
    a, b, a_blocks, b_blocks, pairs, n_c, (crows, ccols) = _case(block, shape, garbage_run)
    ta, tb = torch.from_numpy(a_blocks), torch.from_numpy(b_blocks)
    got_ref = bsr_spgemm_ref(ta, tb, *(torch.from_numpy(x) for x in pairs), n_c)
    got = bsr_spgemm(ta, tb, *pairs, n_c)  # CPU tensors: the plain version
    want_ref = np.asarray(jax_ref(jnp.asarray(a_blocks), jnp.asarray(b_blocks), *pairs, n_c))
    want_kernel = np.asarray(
        jax_bsr_spgemm(a_blocks, b_blocks, *pairs, n_c, interpret=True)
    )
    assert got.dtype == got_ref.dtype == torch.float32
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(got_ref.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # and the C blocks assemble to the dense product
    m, _, n = shape
    c = bsr_to_dense(BlockSparse(got.numpy()[: len(crows)], crows, ccols, (m, n)))
    np.testing.assert_allclose(c, a @ b, rtol=1e-4, atol=1e-4)
    if garbage_run:
        assert not got[-1].any()


@pytest.mark.parametrize("block", [1, 8, 16])
def test_ref_matches_jax_bf16(block):
    _, _, a_blocks, b_blocks, pairs, n_c, _ = _case(block, (48, 48, 48), garbage_run=True)
    ta = torch.from_numpy(a_blocks).to(torch.bfloat16)
    tb = torch.from_numpy(b_blocks).to(torch.bfloat16)
    got = bsr_spgemm(ta, tb, *pairs, n_c)
    assert got.dtype == torch.bfloat16
    # the reference sees exactly the bf16-rounded inputs, in fp32
    a32, b32 = ta.float().numpy(), tb.float().numpy()
    for want in (
        np.asarray(jax_ref(jnp.asarray(a32), jnp.asarray(b32), *pairs, n_c)),
        np.asarray(jax_bsr_spgemm(a32, b32, *pairs, n_c, interpret=True)),
    ):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)
    # mixed inputs promote like the reference: bf16 x fp32 -> fp32
    mixed = bsr_spgemm(ta, torch.from_numpy(b32), *pairs, n_c)
    assert mixed.dtype == torch.float32


def test_pair_runs():
    run_start, run_c = pair_runs(np.array([0, 0, 2, 2, 2, 5, 7, 7]))
    assert run_start.dtype == run_c.dtype == np.int32
    np.testing.assert_array_equal(run_start, [0, 2, 5, 6, 8])
    np.testing.assert_array_equal(run_c, [0, 2, 5, 7])
    run_start, run_c = pair_runs(np.zeros(0, np.int64))
    np.testing.assert_array_equal(run_start, [0])
    assert len(run_c) == 0
    with pytest.raises(ValueError, match="sorted"):
        pair_runs(np.array([1, 0]))


# the shapes and tolerance of tests/test_kernels.py's spgemm test
@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("shape", [(32, 16, 48), (48, 48, 48)])
def test_ops_spgemm_matches_jax(block, shape):
    m, k, n = shape
    rng = np.random.default_rng(1)
    a = _random_block_dense(rng, m, k, 0.5, block)
    b = _random_block_dense(rng, k, n, 0.5, block)
    ab, bb = to_bsr(a, block, block), to_bsr(b, block, block)
    got, crows, ccols = ops.spgemm(ab, bb, device="cpu")
    want, jrows, jcols = jax_ops.spgemm(_jax_bsr(ab), _jax_bsr(bb), interpret=True)
    np.testing.assert_array_equal(crows, jrows)
    np.testing.assert_array_equal(ccols, jcols)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    c = bsr_to_dense(BlockSparse(got.numpy(), crows, ccols, (m, n)))
    np.testing.assert_allclose(c, a @ b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bm, bk, bn", [(8, 16, 8), (16, 8, 32), (4, 8, 12)])
def test_ops_spgemm_rectangular_blocks_match_jax(bm, bk, bn):
    """(bm, bk) A blocks times (bk, bn) B blocks, as the JAX kernel takes."""
    rng = np.random.default_rng(9)
    a = (rng.standard_normal((48, 64)) * (rng.random((48, 64)) < 0.1)).astype(np.float32)
    b = (rng.standard_normal((64, 96)) * (rng.random((64, 96)) < 0.1)).astype(np.float32)
    ab, bb = to_bsr(a, bm, bk), to_bsr(b, bk, bn)
    got, crows, ccols = ops.spgemm(ab, bb, device="cpu")
    assert got.shape[1:] == (bm, bn)
    want, jrows, jcols = jax_ops.spgemm(_jax_bsr(ab), _jax_bsr(bb), interpret=True)
    np.testing.assert_array_equal(crows, jrows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    c = bsr_to_dense(BlockSparse(got.numpy(), crows, ccols, (ab.shape[0], bb.shape[1])))
    np.testing.assert_allclose(c[:48, :96], a @ b, rtol=1e-4, atol=1e-4)


def test_ops_spgemm_with_no_block_pairs_is_empty_like_jax():
    a = np.zeros((16, 16), np.float32)
    a[:8, :8] = 1.0  # A only in block-column 0
    b = np.zeros((16, 16), np.float32)
    b[8:, 8:] = 1.0  # B only in block-row 1
    ab, bb = to_bsr(a, 8, 8), to_bsr(b, 8, 8)
    got, crows, ccols = ops.spgemm(ab, bb, device="cpu")
    want, jrows, _ = jax_ops.spgemm(_jax_bsr(ab), _jax_bsr(bb), interpret=True)
    assert got.shape == tuple(want.shape) == (0, 8, 8)
    assert got.dtype == torch.float32 and len(crows) == len(jrows) == 0


def test_inner_block_sizes_must_agree():
    a, b = torch.ones(2, 8, 16), torch.ones(2, 8, 8)
    with pytest.raises(ValueError, match="inner size"):
        bsr_spgemm(a, b, [0], [0], [0], 1)


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    _, _, a_blocks, b_blocks, (pa, pb, pc), n_c, _ = _case(8, (32, 16, 48))
    ta, tb = torch.from_numpy(a_blocks), torch.from_numpy(b_blocks)
    before = dict(bsr_spgemm_local.launches)
    bsr_spgemm(ta, tb, pa, pb, pc, n_c)
    assert bsr_spgemm_local.launches == before  # the CPU path launches no kernel
    with pytest.raises(ValueError, match="pair_a"):
        bsr_spgemm(ta, tb, pa + len(a_blocks), pb, pc, n_c)
    with pytest.raises(ValueError, match="pair_c"):
        bsr_spgemm(ta, tb, pa, pb, pc, int(pc.max()))
    with pytest.raises(ValueError, match="on meta"):
        bsr_spgemm_local(
            ta, tb.to("meta"), *(torch.as_tensor(x) for x in (pa, pb, pc)),
            *(torch.as_tensor(x) for x in pair_runs(pc)), n_c,
        )


@pytest.mark.parametrize(
    "bm, bk, bn, kernel",
    [
        (1, 1, 1, "scalar_runs"),
        (8, 8, 8, "warp_runs"),
        (16, 16, 16, "warp_runs"),  # the block16-4096 path
        (8, 16, 8, "warp_runs"),
        (4, 8, 12, "warp_runs"),
        (1, 8, 1, "warp_runs"),
        (16, 8, 32, "tile_runs"),
        (32, 32, 32, "tile_runs"),  # block16-4096 retiled 32
        (8, 64, 8, "tile_runs"),  # bk over 16
        (64, 64, 64, "mma_runs"),  # block16-4096 retiled 64
        (128, 128, 128, "mma_runs"),
        (48, 8, 16, "mma_runs"),
        (3, 5, 33, "mma_runs"),
    ],
)
def test_route_picks_the_kernel_by_block_shape(bm, bk, bn, kernel):
    assert route(bm, bk, bn) == kernel
    assert kernel in KERNELS and set(bsr_spgemm_local.launches) == set(KERNELS)


def _rect_case(shape, garbage_run, seed):
    """Seeded (bm, bk) A blocks and (bk, bn) B blocks on 3 x 4 and 4 x 3
    block grids and their pair lists, optionally with a trailing run of
    padding pairs into an extra C slot (as ``_case``)."""
    bm, bk, bn = shape
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3 * bm, 4 * bk)).astype(np.float32)
    a *= np.kron(rng.random((3, 4)) < 0.7, np.ones((bm, bk), np.float32))
    b = rng.standard_normal((4 * bk, 3 * bn)).astype(np.float32)
    b *= np.kron(rng.random((4, 3)) < 0.7, np.ones((bk, bn), np.float32))
    ab, bb = to_bsr(a, bm, bk), to_bsr(b, bk, bn)
    pa, pb, pc, crows, ccols = build_pair_lists(ab.brows, ab.bcols, bb.brows, bb.bcols)
    a_blocks, b_blocks, n_c = ab.blocks, bb.blocks, len(crows)
    if garbage_run:
        a_blocks = np.concatenate([a_blocks, np.zeros((1, bm, bk), np.float32)])
        b_blocks = np.concatenate([b_blocks, np.zeros((1, bk, bn), np.float32)])
        pa = np.r_[pa, np.full(5, len(a_blocks) - 1)]
        pb = np.r_[pb, np.full(5, len(b_blocks) - 1)]
        pc = np.r_[pc, np.full(5, n_c)]
        n_c += 1
    return a, b, a_blocks, b_blocks, (pa, pb, pc), n_c, (crows, ccols)


# the shapes tile_runs takes on the card: the retiled-32 product's blocks,
# sides off 8 and 16 (every copy element by element on 16-bit), and bk over
# 16 with small bm and bn
TILE_SHAPES = [(32, 32, 32), (24, 20, 28), (8, 64, 8)]


@pytest.mark.parametrize("garbage_run", [False, True])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_tile_shapes_match_jax(shape, garbage_run):
    """The port's wrapper on CPU tensors (the plain version) at the block
    shapes tile_runs takes, against the JAX oracle and its kernel in
    interpret mode, and the C blocks against the dense product."""
    a, b, a_blocks, b_blocks, pairs, n_c, (crows, ccols) = _rect_case(shape, garbage_run, 3)
    got = bsr_spgemm(torch.from_numpy(a_blocks), torch.from_numpy(b_blocks), *pairs, n_c)
    want_ref = np.asarray(jax_ref(jnp.asarray(a_blocks), jnp.asarray(b_blocks), *pairs, n_c))
    want_kernel = np.asarray(jax_bsr_spgemm(a_blocks, b_blocks, *pairs, n_c, interpret=True))
    assert got.shape == (n_c, shape[0], shape[2]) and got.dtype == torch.float32
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    c = bsr_to_dense(BlockSparse(got.numpy()[: len(crows)], crows, ccols, (a.shape[0], b.shape[1])))
    np.testing.assert_allclose(c, a @ b, rtol=1e-4, atol=1e-4)
    if garbage_run:
        assert not got[-1].any()


def _tile_order(a_blocks, b_blocks, pair_a, pair_b, pair_c, n_c):
    """tile_runs' order of summation in plain PyTorch: each C block's pairs
    in order, each pair's k in steps (128 bytes of an A row: 32 values in
    fp32, 64 in 16-bit) zero-padded past bk, 16-bit steps as k16 mma
    products; every step's products summed in fp32 and added to the C
    block's fp32 sum, which is rounded once.  C slots no pair names are
    zero."""
    _, bm, bk = a_blocks.shape
    bn = b_blocks.shape[2]
    out_dtype = torch.promote_types(a_blocks.dtype, b_blocks.dtype)
    step = 32 if out_dtype == torch.float32 else 16
    pad = -bk % step
    a = torch.nn.functional.pad(a_blocks.float(), (0, pad))
    b = torch.nn.functional.pad(b_blocks.float(), (0, 0, 0, pad))
    out = torch.zeros((n_c, bm, bn))
    for i, j, c in zip(pair_a, pair_b, pair_c):
        for k0 in range(0, bk + pad, step):
            out[c] += a[i, :, k0:k0 + step] @ b[j, k0:k0 + step]
    return out.to(out_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_tile_runs_order_matches_jax(shape, dtype):
    """The plain model of tile_runs' order, with a garbage run, against the
    JAX oracle and kernel in interpret mode (given the values as the model
    sees them, in fp32) and float64.  fp32: within 1e-5 of all three.
    bf16: the model sums exact products in fp32 and rounds once, so it is
    within 1e-5 of float64 before the rounding and half a bf16 ulp (2^-8
    relative) after it, and JAX (fp32 sums of the same products) rounded
    the same way; the port's plain version is within one ulp (2^-7) of it."""
    _, _, a_blocks, b_blocks, pairs, n_c, _ = _rect_case(shape, True, 5)
    ta = torch.from_numpy(a_blocks).to(dtype)
    tb = torch.from_numpy(b_blocks).to(dtype)
    got = _tile_order(ta, tb, *pairs, n_c)
    assert not got[-1].any()
    a32, b32 = ta.float().numpy(), tb.float().numpy()
    want64 = bsr_spgemm_ref(
        torch.from_numpy(a32).double(), torch.from_numpy(b32).double(),
        *(torch.from_numpy(x) for x in pairs), n_c,
    ).numpy()
    for want in (
        np.asarray(jax_ref(jnp.asarray(a32), jnp.asarray(b32), *pairs, n_c)),
        np.asarray(jax_bsr_spgemm(a32, b32, *pairs, n_c, interpret=True)),
    ):
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        else:
            assert (np.abs(got.float().numpy() - want) <= 2.0**-8 * np.abs(want) + 1e-5).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want64, rtol=1e-5, atol=1e-5)
    else:
        unrounded = _tile_order(ta.float(), tb.float(), *pairs, n_c)
        np.testing.assert_allclose(unrounded.numpy(), want64, rtol=1e-5, atol=1e-5)
        assert (np.abs(got.float().numpy() - want64) <= 2.0**-8 * np.abs(want64) + 1e-5).all()
    plain = bsr_spgemm(ta, tb, *pairs, n_c)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    np.testing.assert_allclose(plain.float().numpy(), got.float().numpy(), rtol=tol, atol=1e-5)
