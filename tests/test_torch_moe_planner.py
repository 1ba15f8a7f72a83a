"""The port's MoE dispatch planner is exactly the JAX package's: the routing
counts, the dispatch SpGEMM instance and its hypergraph, and the expert
placement (permutation, columns, both cut costs, both load imbalances) on
the correlated routing of ``tests/test_moe_planner.py``."""
import numpy as np
import pytest

import repro.core.moe_planner as jax_planner
import repro_torch.core.moe_planner as planner
from repro.core import build_model as jax_build_model
from repro_torch.core import build_model


def _correlated_routing(T=4096, E=16, K=2, n_blocks=4, seed=0):
    """Token span i prefers the expert block i mod n_blocks, but the expert
    ids within a 'semantic' block are scattered across the naive layout."""
    rng = np.random.default_rng(seed)
    scattered = rng.permutation(E).reshape(n_blocks, E // n_blocks)
    gate = np.empty((T, K), dtype=np.int64)
    for t in range(T):
        blk = (t * n_blocks) // T
        gate[t] = rng.choice(scattered[blk], size=K, replace=False)
    return gate


CASES = {  # (T, E, K, n_blocks, groups, columns)
    "E16": (4096, 16, 2, 4, 64, 4),
    "E16-2col": (512, 16, 2, 2, 16, 2),
    "E32-top4": (2048, 32, 4, 4, 32, 8),
}


@pytest.mark.parametrize("groups", [1, 7, 32])
def test_routing_counts_equal_jax(groups):
    gate = _correlated_routing()
    got = planner.routing_counts(gate, 16, groups)
    want = jax_planner.routing_counts(gate, 16, groups)
    assert got.dtype == want.dtype and got.shape == (groups, 16)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == gate.size


@pytest.mark.parametrize("case", sorted(CASES))
def test_dispatch_instance_equals_jax(case):
    T, E, K, blocks, groups, _ = CASES[case]
    counts = planner.routing_counts(_correlated_routing(T, E, K, blocks), E, groups)
    ti, ji = planner.dispatch_instance(counts), jax_planner.dispatch_instance(counts)
    assert ti.shape == ji.shape == (E, groups, 1) and ti.name == ji.name
    assert ti.n_mult == ji.n_mult == (counts > 0).sum()
    for side in ("a", "b", "c"):
        np.testing.assert_array_equal(getattr(ti, side).indptr, getattr(ji, side).indptr)
        np.testing.assert_array_equal(getattr(ti, side).indices, getattr(ji, side).indices)
    th, jh = build_model(ti, "rowwise"), jax_build_model(ji, "rowwise")
    for field in ("net_ptr", "net_pins", "w_comp", "w_mem", "net_cost"):
        np.testing.assert_array_equal(getattr(th, field), getattr(jh, field), field)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_placement_equals_jax(case, seed):
    T, E, K, blocks, groups, cols = CASES[case]
    counts = planner.routing_counts(_correlated_routing(T, E, K, blocks), E, groups)
    got = planner.plan_expert_placement(counts, n_columns=cols, seed=seed)
    want = jax_planner.plan_expert_placement(counts, n_columns=cols, seed=seed)
    for field in ("placement", "column_of"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), field)
    for field in ("comm_planned", "comm_contiguous", "load_imbalance_planned",
                  "load_imbalance_contiguous"):
        assert getattr(got, field) == getattr(want, field), field
    assert sorted(got.placement.tolist()) == list(range(E))
    assert (np.bincount(got.column_of, minlength=cols) == E // cols).all()
    assert got.comm_planned < got.comm_contiguous


def test_indivisible_columns_raise_as_jax():
    counts = planner.routing_counts(_correlated_routing(), 16, 8)
    with pytest.raises(ValueError, match="not divisible"):
        planner.plan_expert_placement(counts, n_columns=3)
