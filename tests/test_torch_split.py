"""The arithmetic of the port's fp32 tensor-core routes, on the CPU.

K3's ``expert_split`` and K1's ``mma_runs`` write each fp32 operand as three
bf16 pieces (``split3_bf16_ref``, exact) and sum the six products of pieces
x_i y_j with i + j <= 2 in fp32.  A plain PyTorch model of that sum is held
here against the JAX package's fp32 kernels (Pallas, interpret mode) at
1e-4, at K3's Qwen3-MoE depth (d = 4096) and at K1 blocks of 64 with runs of
20 pairs and more on N(0, 1) data; a two-piece, three-product version of the
same model fails that tolerance on the K1 case, which is why three pieces
are used.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bsr_spgemm import bsr_spgemm as jax_bsr_spgemm
from repro.kernels.moe_gemm import moe_gemm as jax_moe_gemm
from repro_torch.kernels.bsr_spgemm import build_pair_lists
from repro_torch.kernels.moe_gemm import moe_gemm, split3_bf16
from repro_torch.kernels.ref import bsr_spgemm_ref, moe_gemm_ref, split3_bf16_ref
from repro_torch.sparse.bsr import to_bsr

TOL = 1e-4  # the port's fp32 tolerance: |got - want| <= TOL + TOL |want|


def _wide_fp32(rng, n, lo, hi):
    """n fp32 values with random signs, full 24-bit significands and
    exponents uniform in [lo, hi)."""
    sig = 1 + rng.integers(0, 2**23, n) / 2**23
    sign = rng.choice([-1.0, 1.0], n)
    return (sign * np.ldexp(sig, rng.integers(lo, hi, n))).astype(np.float32)


def _split2_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 as two bf16 pieces (16 significant bits): the scheme not taken."""
    x0 = x.to(torch.bfloat16)
    return torch.stack([x0, (x - x0.float()).to(torch.bfloat16)])


def _pairs(n_pieces):
    """The products of pieces kept: i + j < n_pieces, small terms first."""
    return sorted(
        ((i, j) for i in range(n_pieces) for j in range(n_pieces) if i + j < n_pieces),
        key=lambda ij: -sum(ij),
    )


def _split_sum(product, x, y, split):
    """sum over kept (i, j) of product(x_i, y_j), each in fp32, summed in fp32."""
    xs, ys = split(x), split(y)
    n = len(xs)
    return sum(product(xs[i].float(), ys[j].float()) for i, j in _pairs(n))


def _within(got, want) -> np.ndarray:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) <= TOL + TOL * np.abs(want)


@pytest.mark.parametrize("lo, hi", [(-60, 60), (-100, -20), (20, 100), (-3, 3)])
def test_split3_is_exact(lo, hi):
    rng = np.random.default_rng(hi - lo)
    x = torch.from_numpy(_wide_fp32(rng, 200_000, lo, hi))
    pieces = split3_bf16_ref(x)
    assert pieces.shape == (3, *x.shape) and pieces.dtype == torch.bfloat16
    total = pieces[0].double() + pieces[1].double() + pieces[2].double()
    assert torch.equal(total, x.double())
    # and the pieces shrink: each is at most 2^-8 of the one before
    assert bool((pieces[1].double().abs() <= pieces[0].double().abs() * 2**-8).all())
    assert bool((pieces[2].double().abs() <= pieces[1].double().abs() * 2**-8).all())


def test_split3_of_bf16_values_has_zero_tails():
    """Mixed inputs meet at fp32: a bf16 x split again is (x, 0, 0)."""
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)).bfloat16().float()
    pieces = split3_bf16_ref(x)
    assert torch.equal(pieces[0].float(), x)
    assert not pieces[1].any() and not pieces[2].any()


def test_split3_wrapper_on_the_cpu_is_the_plain_version():
    x = torch.from_numpy(_wide_fp32(np.random.default_rng(1), 999, -10, 10))
    before = dict(moe_gemm.launches)
    assert torch.equal(split3_bf16(x), split3_bf16_ref(x))
    assert moe_gemm.launches == before  # the CPU path launches no kernel


def _k3_case(seed):
    """A K3 case at Qwen3-MoE's depth: x ~ N(0, 1), w ~ N(0, 1/d), fp32."""
    E, C, d, f = 2, 16, 4096, 32
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
    want = np.asarray(jax_moe_gemm(jnp.asarray(x), jnp.asarray(w), b_c=16, b_f=32, b_d=512,
                                   interpret=True))
    return torch.from_numpy(x), torch.from_numpy(w), want


@pytest.mark.parametrize("seed", [0, 1])
def test_six_products_match_jax_moe_gemm_at_qwen3_depth(seed):
    x, w, want = _k3_case(seed)
    assert bool((x != x.bfloat16().float()).any())  # not bf16 values
    got = _split_sum(moe_gemm_ref, x, w, split3_bf16_ref)
    assert got.dtype == torch.float32
    assert _within(got.numpy(), want).all()
    # the kernels' plain version agrees too
    assert _within(moe_gemm_ref(x, w).numpy(), want).all()


def _k1_case(seed, run_len, block=64):
    """Blocks of 64, N(0, 1): a (2 x run_len) by (run_len x 2) block grid,
    so each of the four C blocks sums a run of run_len pairs."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2 * block, run_len * block)).astype(np.float32)
    b = rng.standard_normal((run_len * block, 2 * block)).astype(np.float32)
    ab, bb = to_bsr(a, block, block), to_bsr(b, block, block)
    pa, pb, pc, crows, _ = build_pair_lists(ab.brows, ab.bcols, bb.brows, bb.bcols)
    assert np.bincount(pc).min() >= run_len
    want = np.asarray(
        jax_bsr_spgemm(ab.blocks, bb.blocks, pa, pb, pc, len(crows), interpret=True)
    )
    idx = [torch.from_numpy(i) for i in (pa, pb, pc)]

    def product(x, y):
        return bsr_spgemm_ref(x, y, *idx, len(crows))

    return torch.from_numpy(ab.blocks), torch.from_numpy(bb.blocks), product, want


@pytest.mark.parametrize("seed, run_len", [(0, 20), (1, 24), (2, 32)])
def test_six_products_match_jax_bsr_spgemm_on_long_runs(seed, run_len):
    a, b, product, want = _k1_case(seed, run_len)
    got = _split_sum(product, a, b, split3_bf16_ref)
    assert got.dtype == torch.float32
    assert _within(got.numpy(), want).all()


def test_two_pieces_fail_where_three_pass():
    """Two pieces with three products keep 16 significant bits: on long runs
    of N(0, 1) blocks the sums miss 1e-4."""
    a, b, product, want = _k1_case(0, 20)
    two = _split_sum(product, a, b, _split2_bf16)
    three = _split_sum(product, a, b, split3_bf16_ref)
    assert not _within(two.numpy(), want).all()
    assert _within(three.numpy(), want).all()
