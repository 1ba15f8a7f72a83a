"""The BSR SpGEMM kernel's plain version and its wrapper on the CPU, held
against the JAX package's oracle and its Pallas kernel in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bsr_spgemm import bsr_spgemm as jax_bsr_spgemm
from repro.kernels.ref import bsr_spgemm_ref as jax_ref
from repro_torch.kernels.bsr_spgemm import (
    bsr_spgemm,
    bsr_spgemm_local,
    build_pair_lists,
    pair_runs,
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
