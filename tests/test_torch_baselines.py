"""The paper's baseline partitions and the last surface names the port
lacked, held exactly to the JAX package: ``partition_random`` and
``partition_block``, ``geometric_row_partition`` with ``_factor3``,
``pad_blocks``, ``SparseStructure.nz_ids`` and ``has_empty_rows_or_cols``,
``CompiledSpGEMM.cost_model_words``, ``runtime.cache_clear`` and the
top-level names (``FaultPolicy``, ``device_count``, ``SpGEMMSession``)."""
import importlib

import numpy as np
import pytest

import repro
import repro_torch
from repro.core import build_model as jax_build_model
from repro.core import matrices as jax_matrices
from repro.core import partition_block as jax_partition_block
from repro.core import partition_random as jax_partition_random
from repro.sparse.bsr import pad_blocks as jax_pad_blocks
from repro.sparse.bsr import to_bsr as jax_to_bsr
from repro.sparse.structure import random_structure as jax_random_structure
from repro_torch.core import build_model, matrices, partition_block, partition_random
from repro_torch.distributed import runtime
from repro_torch.sparse import pad_blocks, to_bsr
from repro_torch.sparse.structure import random_structure
from test_torch_planning import _instances


@pytest.mark.parametrize("p", [1, 3, 4, 8])
@pytest.mark.parametrize("model", ["rowwise", "outer", "monoC", "fine"])
@pytest.mark.parametrize("name", ["random", "amg"])
def test_baseline_partitions_equal_jax(name, model, p):
    jinst, tinst = _instances(name)
    jh, th = jax_build_model(jinst, model), build_model(tinst, model)
    for seed in (0, 7):
        jr, tr = jax_partition_random(jh, p, seed=seed), partition_random(th, p, seed=seed)
        np.testing.assert_array_equal(jr.parts, tr.parts)
        assert (jr.p, jr.connectivity) == (tr.p, tr.connectivity)
    jr, tr = jax_partition_block(jh, p), partition_block(th, p)
    np.testing.assert_array_equal(jr.parts, tr.parts)
    assert (jr.p, jr.connectivity) == (tr.p, tr.connectivity)
    assert tr.parts.min() >= 0 and tr.parts.max() < p


@pytest.mark.parametrize("n,p", [(6, 4), (6, 8), (9, 27), (7, 6), (10, 12), (5, 1), (6, 7)])
def test_geometric_row_partition_equals_jax(n, p):
    got = matrices.geometric_row_partition(n, p)
    np.testing.assert_array_equal(got, jax_matrices.geometric_row_partition(n, p))
    assert got.dtype == np.int64 and got.shape == (n**3,)
    assert set(np.unique(got)) <= set(range(p))


def test_factor3_equals_jax():
    for p in range(1, 130):
        f = matrices._factor3(p)
        assert f == jax_matrices._factor3(p) and int(np.prod(f)) == p


def test_pad_blocks_equals_jax():
    dense = np.kron(np.random.default_rng(2).random((3, 4)) < 0.5, np.ones((4, 4)))
    dense = dense.astype(np.float32)
    jb, tb = jax_to_bsr(dense, 4, 4), to_bsr(dense, 4, 4)
    for n in (tb.n_blocks, tb.n_blocks + 5):
        jp, tp = jax_pad_blocks(jb, n), pad_blocks(tb, n)
        for f in ("blocks", "brows", "bcols"):
            np.testing.assert_array_equal(getattr(jp, f), getattr(tp, f))
        assert jp.shape == tp.shape and tp.n_blocks == n
    with pytest.raises(ValueError, match="cannot shrink"):
        pad_blocks(tb, tb.n_blocks - 1)


def test_nz_ids_and_empty_rows_equal_jax():
    rng_j, rng_t = np.random.default_rng(4), np.random.default_rng(4)
    js, ts = jax_random_structure(12, 9, 0.25, rng_j), random_structure(12, 9, 0.25, rng_t)
    rows, cols = ts.coo()
    perm = np.random.default_rng(1).permutation(len(rows))
    got = ts.nz_ids(rows[perm], cols[perm])
    np.testing.assert_array_equal(got, js.nz_ids(rows[perm], cols[perm]))
    np.testing.assert_array_equal(got, perm)
    missing = np.flatnonzero(~ts.csr.toarray()[0])[:1]
    if len(missing):
        with pytest.raises(KeyError, match="not a nonzero"):
            ts.nz_ids(np.zeros(1, np.int64), missing)
    for j_s, t_s in ((js, ts), (jax_matrices.stencil27(3), matrices.stencil27(3))):
        assert t_s.has_empty_rows_or_cols() == j_s.has_empty_rows_or_cols()


def test_top_level_names_equal_jax():
    assert repro_torch.__all__ == repro.__all__
    from repro_torch.distributed.session import SpGEMMSession
    from repro_torch.resilience import FaultPolicy

    assert repro_torch.FaultPolicy is FaultPolicy
    assert repro_torch.SpGEMMSession is SpGEMMSession
    # the port counts CUDA devices (ROADMAP.md Queue 3): none here
    assert repro_torch.device_count() == 0


@pytest.mark.parametrize("model", ["monoC", "rowwise", "outer", "fine", "summa2d"])
def test_cost_model_words_equal_jax(model):
    rng = np.random.default_rng(9)
    a_s = random_structure(16, 12, 0.3, rng)
    b_s = random_structure(12, 14, 0.3, rng)
    jax_rng = np.random.default_rng(9)
    ja = jax_random_structure(16, 12, 0.3, jax_rng)
    jb = jax_random_structure(12, 14, 0.3, jax_rng)
    words = repro_torch.plan(a_s, b_s, p=2, model=model).compile(device="cpu").cost_model_words
    plan = repro.plan(ja, jb, p=2, model=model).execution_plan
    assert words == (plan.comm_words_ideal, plan.comm_words_padded)


def test_cache_clear_empties_the_lru():
    rng = np.random.default_rng(3)
    a_s = random_structure(10, 8, 0.3, rng)
    repro_torch.plan(a_s, a_s.transpose(), p=2, model="monoC").compile(device="cpu")
    assert runtime.cache_info()["size"] >= 1
    runtime.cache_clear()
    assert runtime.cache_info() == {"size": 0, "max_size": runtime.CACHE_SIZE,
                                    "hits": 0, "misses": 0}
    jax_runtime = importlib.import_module("repro.distributed.runtime")
    assert hasattr(jax_runtime, "cache_clear")
