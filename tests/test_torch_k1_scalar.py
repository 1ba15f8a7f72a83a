"""K1's ``scalar_runs`` (1 x 1 x 1 blocks): a plain model of how the kernel
splits the pairs among warps and in what order it sums them, held against
the JAX package's ``bsr_spgemm`` in interpret mode, its reference and
float64, on run lengths that cross the kernel's spans and windows (the
model: ``k1_scalar_model``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bsr_spgemm import bsr_spgemm as jax_bsr_spgemm
from repro.kernels.ref import bsr_spgemm_ref as jax_ref
from repro_torch.kernels.bsr_spgemm import bsr_spgemm, pair_runs
from repro_torch.kernels.ref import bsr_spgemm_ref

from k1_scalar_model import (CASES, MIN_SPAN, group_sum, hub, mcl_facebook, piece_sum,
                             runs_own_order, scalar_walk)


@pytest.mark.parametrize("span", [MIN_SPAN, 128, 256, 640])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scalar_split_sums_each_pair_once_in_the_runs_order(case, span):
    """Every pair is summed in exactly one window, no window uses more than
    its 32 lanes, every C slot is written, and C is each run's own order
    bit for bit, whatever the span."""
    a, b, pa, pb, pc, n_c = CASES[case]()
    x, y = a[pa], b[pb]
    run_start, run_c = pair_runs(pc)
    want = runs_own_order(x, y, run_start, run_c, n_c)
    got, summed, windows = scalar_walk(x, y, pc, n_c, span)
    assert (summed == 1).all()
    assert all(0 < lanes <= 32 for lanes in windows)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_scalar_split_gives_each_copy_of_a_batch_its_own_bits():
    """A batched launch runs m copies of the pair lists, each offset into
    its own tables and C slots: every copy's C is the single launch's bit
    for bit (the runs' order does not depend on where they sit)."""
    a, b, pa, pb, pc, n_c = hub()
    single, _, _ = scalar_walk(a[pa], b[pb], pc, n_c, 128)
    rng = np.random.default_rng(8)
    sets = [(a, b)] + [(rng.standard_normal(64).astype(np.float32),
                        rng.standard_normal(64).astype(np.float32)) for _ in range(2)]
    x = np.concatenate([sa[pa] for sa, _ in sets])
    y = np.concatenate([sb[pb] for _, sb in sets])
    batched, summed, _ = scalar_walk(x, y, np.concatenate([pc + i * n_c for i in range(3)]),
                                      3 * n_c, 100)
    assert (summed == 1).all()
    np.testing.assert_array_equal(batched[:n_c], single)
    for i, (sa, sb) in enumerate(sets):
        alone, _, _ = scalar_walk(sa[pa], sb[pb], pc, n_c, 3 * 128)
        np.testing.assert_array_equal(batched[i * n_c:(i + 1) * n_c], alone)


def test_piece_sum_is_the_lanes_then_the_shuffle_tree():
    """``piece_sum`` spelled out at 17 pairs: lanes of 4, 4, 4, 4 and 1
    pairs, each added left to right, then ((g0 + g1) + (g2 + g3)) + g4 (the
    steps off = 1, 2, 4 at lane 0), not the sum left to right."""
    p = np.full(17, 2.0**-24, np.float32)
    p[0] = 1.0
    g = [group_sum(p[i:i + 4]) for i in range(0, 17, 4)]
    assert g[0] == 1.0 and g[1] == 2.0**-22 and g[4] == 2.0**-24
    tree = np.float32(np.float32(np.float32(g[0] + g[1]) + np.float32(g[2] + g[3])) + g[4])
    assert piece_sum(p) == tree
    left = np.float32(0.0)
    for v in p:
        left = np.float32(left + v)
    assert tree != left  # the two orders differ here, so the model pins one


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES) + ["mcl_facebook"])
def test_scalar_order_matches_jax(case, dtype):
    """The model of scalar_runs (values as the kernel reads them, in fp32)
    against the JAX package's bsr_spgemm in interpret mode (on the C slots
    some pair names: it leaves the others unwritten), its reference and
    float64.  fp32: within 1e-5 of all three.  bf16: the model rounds an
    fp32 sum once, so it is within half a bf16 ulp (2^-8 relative) of
    JAX's fp32 sums and of float64, and the port's plain version within
    one ulp (2^-7) of it."""
    a, b, pa, pb, pc, n_c = (mcl_facebook if case == "mcl_facebook" else CASES[case])()
    ta, tb = (torch.from_numpy(v).to(dtype) for v in (a, b))
    a32, b32 = ta.float().numpy(), tb.float().numpy()
    run_start, run_c = pair_runs(pc)
    got32 = runs_own_order(a32[pa], b32[pb], run_start, run_c, n_c)
    got = torch.from_numpy(got32).to(dtype).float().numpy()
    blocks = (a32.reshape(-1, 1, 1), b32.reshape(-1, 1, 1))
    want_ref = np.asarray(jax_ref(*(jnp.asarray(v) for v in blocks), pa, pb, pc, n_c)).ravel()
    want_kernel = np.asarray(jax_bsr_spgemm(*blocks, pa, pb, pc, n_c, interpret=True)).ravel()
    want64 = bsr_spgemm_ref(*(torch.from_numpy(v).double() for v in blocks),
                            *(torch.from_numpy(v) for v in (pa, pb, pc)), n_c).numpy().ravel()
    covered = np.zeros(n_c, bool)
    covered[pc] = True
    assert (got[~covered] == 0).all()
    for want, where in ((want_ref, slice(None)), (want_kernel, covered), (want64, slice(None))):
        if dtype == torch.float32:
            np.testing.assert_allclose(got[where], want[where], rtol=1e-5, atol=1e-5)
        else:
            err = np.abs(got[where] - want[where])
            assert (err <= 2.0**-8 * np.abs(want[where]) + 1e-5).all()
    if dtype == torch.bfloat16:  # the unrounded sums: fp32's rule
        np.testing.assert_allclose(got32, want64, rtol=1e-5, atol=1e-5)
    plain = bsr_spgemm(ta.reshape(-1, 1, 1), tb.reshape(-1, 1, 1), pa, pb, pc, n_c)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    np.testing.assert_allclose(plain.float().numpy().ravel(), got, rtol=tol, atol=1e-5)
