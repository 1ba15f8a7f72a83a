"""The rest of the port's numpy planning is exactly the JAX package's: the
Sec. 5.1 vertex coarsening, the Sec. 5.5 SpMV models, the Sec. 5.6 masked
and symmetric-input models, the hypergraph helpers, the sequential I/O
estimate, ``flops`` and the loop-based rowwise builder, on the cases of
``tests/test_coarsen_spmv.py``.  Every comparison here is exact."""
import warnings

import numpy as np
import pytest

import repro.core as jax_core
import repro.core.coarsen as jax_coarsen
import repro_torch.core as core
import repro_torch.core.coarsen as coarsen
import repro_torch.distributed
from repro.distributed.plan import build_rowwise_plan_loop as jax_rowwise_loop
from repro.sparse import structure as jax_structure
from repro_torch.distributed.plan import build_rowwise_plan, build_rowwise_plan_loop
from repro_torch.sparse import structure


def _same_hypergraph(jh, th):
    assert (jh.n_vertices, jh.n_nets, jh.name) == (th.n_vertices, th.n_nets, th.name)
    for field in ("net_ptr", "net_pins", "w_comp", "w_mem", "net_cost",
                  "vertex_kind", "net_kind"):
        j, t = getattr(jh, field), getattr(th, field)
        assert (j is None) == (t is None), field
        if j is not None:
            assert j.dtype == t.dtype, field
            np.testing.assert_array_equal(j, t, field)


def _pair(fn, *args):
    """``fn`` of each package's ``structure`` on the same seeded draws."""
    return fn(jax_structure, jax_core, *args), fn(structure, core, *args)


def _inst(st, co, seed=0, shape=(20, 15, 18), density=0.2):
    rng = np.random.default_rng(seed)
    a = st.random_structure(shape[0], shape[1], density, rng)
    b = st.random_structure(shape[1], shape[2], density, rng)
    return co.SpGEMMInstance(a, b)


def _symmetric(st, co):
    base = st.random_structure(10, 10, 0.25, np.random.default_rng(9))
    sym = st.SparseStructure.wrap(base.csr + base.csr.T)
    return co.SpGEMMInstance(sym, sym)


def _coarse_map(n_vertices, seed, div=3):
    cmap = np.random.default_rng(seed).integers(0, n_vertices // div, size=n_vertices)
    return np.unique(cmap, return_inverse=True)[1]


@pytest.mark.parametrize("drop_singletons", [True, False])
@pytest.mark.parametrize("unit", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("model", ["fine", "rowwise", "monoC"])
def test_coarsen_vertices_equals_jax(model, unit, drop_singletons):
    ji, ti = _pair(_inst)
    jh = jax_core.build_model(ji, model, include_nz=model == "fine")
    th = core.build_model(ti, model, include_nz=model == "fine")
    cmap = _coarse_map(jh.n_vertices, 1)
    kw = dict(unit_mem=unit[0], unit_comp=unit[1], drop_singletons=drop_singletons)
    _same_hypergraph(jax_coarsen.coarsen_vertices(jh, cmap, **kw),
                     coarsen.coarsen_vertices(th, cmap, **kw))


def test_slicewise_coarsening_equals_jax():
    """The i-slice coarsening of the fine model (the rowwise model's cut)."""
    ji, ti = _pair(_inst, 2)
    jh = jax_coarsen.coarsen_vertices(jax_core.build_model(ji, "fine"), ji.mult_i.copy())
    th = coarsen.coarsen_vertices(core.build_model(ti, "fine"), ti.mult_i.copy())
    _same_hypergraph(jh, th)
    parts = np.random.default_rng(3).integers(0, 4, size=ti.shape[0])[: th.n_vertices]
    jc, tc = jax_core.evaluate(jh, parts, 4), core.evaluate(th, parts, 4)
    np.testing.assert_array_equal(jc.per_part, tc.per_part)
    assert (jc.connectivity, jc.max_part_cost) == (tc.connectivity, tc.max_part_cost)
    rowwise = core.build_model(ti, "rowwise")
    assert tc.connectivity == core.evaluate(rowwise, parts, 4).connectivity


def test_coarsening_to_one_vertex_equals_jax():
    """Every net becomes a singleton and is dropped: the empty coarse graph."""
    ji, ti = _pair(_inst, 4)
    jh, th = jax_core.build_model(ji, "rowwise"), core.build_model(ti, "rowwise")
    cmap = np.zeros(jh.n_vertices, dtype=np.int64)
    _same_hypergraph(jax_coarsen.coarsen_vertices(jh, cmap), coarsen.coarsen_vertices(th, cmap))


@pytest.mark.parametrize("fn", ["spmv_column_net", "spmv_row_net"])
@pytest.mark.parametrize("seed", [4, 5])
def test_spmv_net_models_equal_jax(fn, seed):
    ja = jax_structure.random_structure(12, 9, 0.3, np.random.default_rng(seed))
    ta = structure.random_structure(12, 9, 0.3, np.random.default_rng(seed))
    _same_hypergraph(getattr(jax_coarsen, fn)(ja), getattr(coarsen, fn)(ta))


@pytest.mark.parametrize("case", ["paper", "random"])
def test_spmv_fine_grain_equals_jax(case):
    if case == "paper":  # a zero diagonal at (1, 1): one dummy vertex
        dense = np.array([[1, 1, 0, 0], [0, 0, 1, 0], [1, 0, 1, 0], [0, 1, 0, 1]])
        ja, ta = jax_structure.from_dense(dense), structure.from_dense(dense)
    else:
        ja = jax_structure.random_structure(16, 16, 0.2, np.random.default_rng(11))
        ta = structure.random_structure(16, 16, 0.2, np.random.default_rng(11))
    _same_hypergraph(jax_coarsen.spmv_fine_grain(ja), coarsen.spmv_fine_grain(ta))


def test_spmv_fine_grain_refuses_a_rectangle_as_jax():
    a = structure.random_structure(6, 5, 0.5, np.random.default_rng(0))
    with pytest.raises(ValueError, match="square"):
        coarsen.spmv_fine_grain(a)


@pytest.mark.parametrize("density", [0.5, 1.0, 0.0])
def test_masked_fine_grained_equals_jax(density):
    ji, ti = _pair(_inst, 6 if density < 1 else 8)
    mask = np.random.default_rng(7).random(ji.c.shape) < density
    _same_hypergraph(jax_coarsen.masked_fine_grained(ji, jax_structure.from_dense(mask)),
                     coarsen.masked_fine_grained(ti, structure.from_dense(mask)))


def test_symmetric_input_coarse_map_equals_jax():
    ji, ti = _pair(_symmetric)
    jmap, tmap = jax_coarsen.symmetric_input_coarse_map(ji), coarsen.symmetric_input_coarse_map(ti)
    np.testing.assert_array_equal(jmap, tmap)
    jh = jax_core.build_model(ji, "fine", include_nz=True)
    th = core.build_model(ti, "fine", include_nz=True)
    _same_hypergraph(jax_coarsen.coarsen_vertices(jh, jmap, unit_mem=True),
                     coarsen.coarsen_vertices(th, tmap, unit_mem=True))


@pytest.mark.parametrize("model", ["fine", "rowwise", "monoC"])
def test_hypergraph_helpers_equal_jax(model):
    """``remove_singleton_nets``, ``coalesce_identical_nets`` and
    ``build_hypergraph`` from a list of nets, on a coarsened model that has
    singletons and repeated nets."""
    ji, ti = _pair(_inst, 3)
    jh, th = jax_core.build_model(ji, model), core.build_model(ti, model)
    cmap = _coarse_map(jh.n_vertices, 2, div=2)
    kw = dict(drop_singletons=False)
    jc = jax_coarsen.coarsen_vertices(jh, cmap, **kw)
    tc = coarsen.coarsen_vertices(th, cmap, **kw)
    for fn in ("remove_singleton_nets", "coalesce_identical_nets"):
        _same_hypergraph(getattr(jax_core, fn)(jc), getattr(core, fn)(tc))
        _same_hypergraph(getattr(jax_core, fn)(jh), getattr(core, fn)(th))
    nets = [th.pins_of(n)[::-1] for n in range(th.n_nets)]
    args = (th.n_vertices, th.w_comp, th.w_mem, th.net_cost)
    _same_hypergraph(jax_core.build_hypergraph(nets, *args, name="x"),
                     core.build_hypergraph(nets, *args, name="x"))


@pytest.mark.parametrize("fast_mem", [16, 64])
@pytest.mark.parametrize("model", ["fine", "rowwise", "monoC", "outer"])
def test_sequential_io_estimate_equals_jax(model, fast_mem):
    ji, ti = _pair(_inst, 0, (30, 24, 28), 0.2)
    want = jax_core.sequential_io_estimate(jax_core.build_model(ji, model), fast_mem)
    got = core.sequential_io_estimate(core.build_model(ti, model), fast_mem)
    assert got == want and all(type(got[k]) is type(want[k]) for k in want)


def test_sequential_io_estimate_needs_net_kinds_as_jax():
    hg = coarsen.spmv_column_net(structure.random_structure(8, 8, 0.3, np.random.default_rng(0)))
    with pytest.raises(ValueError, match="net kinds"):
        core.sequential_io_estimate(hg, 16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flops_equals_jax(seed):
    ji, ti = _pair(_inst, seed)
    assert structure.flops(ti.a, ti.b) == jax_structure.flops(ji.a, ji.b) == ti.n_mult


def _same_rowwise(jp, tp):
    assert (jp.model, jp.p) == (tp.model, tp.p)
    for group in ("ownership", "local_ids"):
        jg, tg = getattr(jp, group), getattr(tp, group)
        assert sorted(jg) == sorted(tg)
        for k in jg:
            np.testing.assert_array_equal(jg[k], tg[k], f"{group}[{k}]")
    jr, tr = jp.routes["expand"], tp.routes["expand"]
    np.testing.assert_array_equal(jr.send_idx, tr.send_idx)
    np.testing.assert_array_equal(jr.recv_key, tr.recv_key)
    assert (jr.items_ideal, jr.items_padded) == (tr.items_ideal, tr.items_padded)


@pytest.mark.parametrize("b_part", [False, True])
@pytest.mark.parametrize("p", [1, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_rowwise_plan_loop_equals_jax_and_the_vectorised_builder(seed, p, b_part):
    ji, ti = _pair(_inst, seed, (40, 30, 36), 0.12)
    rng = np.random.default_rng(seed + 10)
    row_part = rng.integers(0, p, size=ti.shape[0])
    bp = rng.integers(0, p, size=ti.shape[1]) if b_part else None
    loop = build_rowwise_plan_loop(ti, row_part, p, bp)
    _same_rowwise(jax_rowwise_loop(ji, row_part, p, bp), loop)
    vec = build_rowwise_plan(ti, row_part, p, bp)
    np.testing.assert_array_equal(vec.routes["expand"].send_idx, loop.routes["expand"].send_idx)
    np.testing.assert_array_equal(vec.routes["expand"].recv_key, loop.routes["expand"].recv_key)
    assert vec.routes["expand"].items_ideal == loop.routes["expand"].items_ideal


def test_package_level_loop_builder_warns_once(monkeypatch):
    monkeypatch.setattr(repro_torch.distributed, "_DEPRECATION_WARNED", False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first = repro_torch.distributed.build_rowwise_plan_loop
        second = repro_torch.distributed.build_rowwise_plan_loop
    assert first is second is build_rowwise_plan_loop
    assert [w.category for w in caught] == [DeprecationWarning]
    assert "repro_torch.distributed.plan" in str(caught[0].message)
    assert "build_rowwise_plan_loop" not in repro_torch.distributed.__all__
