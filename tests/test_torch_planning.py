"""The port's planning (numpy/scipy copies) is exactly the JAX package's:
the same instances, hypergraphs, partitions, monoC plans, cost reports and
plan fingerprints from the same inputs.  Every comparison here is exact."""
import numpy as np
import pytest

import repro
import repro_torch
from repro.core import build_model as jax_build_model
from repro.core import matrices as jax_matrices
from repro.core.spgemm_models import MODELS, SpGEMMInstance as JaxInstance
from repro.distributed.plan_ir import plan_monoC_from_dense as jax_plan_from_dense
from repro.distributed.runtime import plan_fingerprint as jax_fingerprint
from repro.kernels.bsr_spgemm import build_pair_lists as jax_pair_lists
from repro.sparse.structure import random_structure as jax_random_structure
from repro_torch.core import build_model, matrices
from repro_torch.core.spgemm_models import SpGEMMInstance
from repro_torch.distributed.plan_ir import (
    MonoCPlan,
    plan_from_reference,
    plan_monoC_from_dense,
)
from repro_torch.distributed.runtime import plan_fingerprint
from repro_torch.kernels.bsr_spgemm import build_pair_lists, build_pair_lists_loop
from repro_torch.sparse.structure import random_structure


def _instances(name: str):
    """(JAX instance, port instance), each built by its own package."""
    if name == "random":
        rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
        ja = jax_random_structure(40, 30, 0.12, rng_j)
        jb = jax_random_structure(30, 36, 0.12, rng_j)
        ta = random_structure(40, 30, 0.12, rng_t)
        tb = random_structure(30, 36, 0.12, rng_t)
        return JaxInstance(ja, jb, name="random"), SpGEMMInstance(ta, tb, name="random")
    if name == "amg":
        return jax_matrices.amg_instances(6)[0], matrices.amg_instances(6)[0]
    return (
        jax_matrices.lp_instance("fome21", scale=0.05),
        matrices.lp_instance("fome21", scale=0.05),
    )


def _same_structure(js, ts):
    assert js.shape == ts.shape
    np.testing.assert_array_equal(js.indptr, ts.indptr)
    np.testing.assert_array_equal(js.indices, ts.indices)


def _same_hypergraph(jh, th):
    assert jh.n_vertices == th.n_vertices and jh.name == th.name
    for field in ("net_ptr", "net_pins", "w_comp", "w_mem", "net_cost",
                  "vertex_kind", "net_kind"):
        np.testing.assert_array_equal(getattr(jh, field), getattr(th, field), field)


def _same_plan(jp, tp):
    assert (jp.model, jp.p) == (tp.model, tp.p)
    for group in ("ownership", "local_ids", "compute"):
        jg, tg = getattr(jp, group), getattr(tp, group)
        assert sorted(jg) == sorted(tg), group
        for k in jg:
            np.testing.assert_array_equal(jg[k], tg[k], f"{group}[{k}]")
    assert sorted(jp.routes) == sorted(tp.routes)
    for k, jr in jp.routes.items():
        tr = tp.routes[k]
        np.testing.assert_array_equal(jr.send_idx, tr.send_idx)
        np.testing.assert_array_equal(jr.recv_key, tr.recv_key)
        for f in ("payload", "items_ideal", "items_padded", "word_size",
                  "words_ideal_override", "words_padded_override"):
            assert getattr(jr, f) == getattr(tr, f), (k, f)
    assert jp.stats == tp.stats
    assert (jp.comm_words_ideal, jp.comm_words_padded) == (
        tp.comm_words_ideal, tp.comm_words_padded
    )


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("name", ["random", "amg", "lp"])
def test_front_door_planning_equals_jax(name, p, seed):
    ji, ti = _instances(name)
    for op in ("a", "b", "c"):
        _same_structure(getattr(ji, op), getattr(ti, op))
    hj = repro.plan(ji, p=p, model="monoC", seed=seed)
    ht = repro_torch.plan(ti, p=p, model="monoC", seed=seed)
    _same_hypergraph(hj.hypergraph, ht.hypergraph)
    np.testing.assert_array_equal(hj.partition.parts, ht.partition.parts)
    assert hj.partition.connectivity == ht.partition.connectivity
    _same_plan(hj.execution_plan, ht.execution_plan)
    assert hj.cost_report() == ht.cost_report()
    assert jax_fingerprint(hj.execution_plan) == plan_fingerprint(ht.execution_plan)


@pytest.mark.parametrize("model", MODELS)
def test_every_model_hypergraph_equals_jax(model):
    ji, ti = _instances("random")
    for include_nz in (False, True):
        _same_hypergraph(
            jax_build_model(ji, model, include_nz=include_nz),
            build_model(ti, model, include_nz=include_nz),
        )


def test_loop_engine_and_include_nz_equal_jax():
    ji, ti = _instances("random")
    hj = repro.plan(ji, p=4, model="monoC", seed=0, engine="loop")
    ht = repro_torch.plan(ti, p=4, model="monoC", seed=0, engine="loop")
    np.testing.assert_array_equal(hj.partition.parts, ht.partition.parts)
    _same_plan(hj.execution_plan, ht.execution_plan)
    # include_nz partitions do not lower for monoC: the report falls back to
    # the generic volume plan on both sides
    hj = repro.plan(ji, p=2, model="monoC", seed=1, include_nz=True)
    ht = repro_torch.plan(ti, p=2, model="monoC", seed=1, include_nz=True)
    assert ht.execution_plan is None
    assert hj.cost_report() == ht.cost_report()
    with pytest.raises(ValueError, match="include_nz"):
        ht.compile(device="cpu")


@pytest.mark.parametrize("p", [2, 4])
def test_tiled_plan_equals_jax_and_survives_plan_from_reference(p):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((48, 40)) * (rng.random((48, 40)) < 0.1)
    b = rng.standard_normal((40, 32)) * (rng.random((40, 32)) < 0.1)
    jp, ji = jax_plan_from_dense(a, b, 8, p, seed=1)
    tp, ti = plan_monoC_from_dense(a, b, 8, p, seed=1)
    _same_structure(ji.c, ti.c)
    _same_plan(jp, tp)
    assert jax_fingerprint(jp) == plan_fingerprint(tp)
    carried = plan_from_reference(jp)
    assert isinstance(carried, MonoCPlan) and carried.a_table_slots == tp.a_table_slots
    _same_plan(jp, carried)
    assert plan_fingerprint(carried) == plan_fingerprint(tp)


def test_pair_lists_byte_identical_to_jax_and_loop():
    rng = np.random.default_rng(4)
    for trial in range(6):
        gm, gk, gn = rng.integers(1, 12, size=3)
        a = np.argwhere(rng.random((gm, gk)) < 0.3)
        b = np.argwhere(rng.random((gk, gn)) < 0.3)
        args = (a[:, 0], a[:, 1], b[:, 0], b[:, 1])
        got = build_pair_lists(*args)
        for want in (jax_pair_lists(*args), build_pair_lists_loop(*args)):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), trial


def test_unported_models_and_engines_raise():
    ji, ti = _instances("random")
    for model in ("auto", "rowwise", "fine", "summa2d"):
        with pytest.raises(ValueError, match="not yet ported"):
            repro_torch.plan(ti, p=2, model=model)
    with pytest.raises(ValueError, match="unknown model"):
        repro_torch.plan(ti, p=2, model="nope")
    with pytest.raises(ValueError, match="device partitioner engine"):
        repro_torch.plan(ti, p=2, model="monoC", engine="device")
