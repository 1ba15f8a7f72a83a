"""The port's device partitioner (``partition(engine="device")``:
``core/refine_device.py``, ``core/coarsen_device.py`` and the drivers in
``core/partition.py``) on the CPU, held to the JAX package bit for bit on
the same seeded instances: the uint32 hash, the padded level arrays, the
refiner's labels and scores, the coarsening maps and coarse levels, and the
partitions of every descend (``coarsen="auto"``, ``"device"`` and
``"host"``) through ``partition`` and the front door, also where the
reference's int32 sort-key guard stops the resident descent.  Then the
engine's own contracts: balance, determinism, phases, deferral to the flat
engine below the size threshold, and the deliberate differences from the
reference — a failing device step raises where JAX warns and falls back,
and ``coarsen="auto"`` takes the host descend where that guard would stop
the resident one before its first step.

As the reference's ``device_everywhere`` fixture does, the size threshold
is monkeypatched to 0 in both packages so the small instances here take
the device path.
"""
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import SpGEMMInstance as JaxInstance
from repro.core import build_model as jax_build_model
from repro.core import partition as jax_partition
from repro.sparse.structure import random_structure as jax_random_structure
from repro_torch.core import SpGEMMInstance, build_model, evaluate
from repro_torch.core.partition import partition
from repro_torch.resilience import FaultPolicy
from repro_torch.sparse.structure import random_structure

jax_partition_mod = importlib.import_module("repro.core.partition")
jax_rd = importlib.import_module("repro.core.refine_device")
jax_cd = importlib.import_module("repro.core.coarsen_device")
partition_mod = importlib.import_module("repro_torch.core.partition")
rd = importlib.import_module("repro_torch.core.refine_device")
cd = importlib.import_module("repro_torch.core.coarsen_device")

# the reference tests' instance families: tests/test_coarsen_device.py
# (_instance, 900 x 700 x 800 at 1%) and tests/test_partition_device.py
# (90 x 70 x 80 at 8%)
LARGE = dict(shape=(900, 700, 800), density=0.01)
SMALL = dict(shape=(90, 70, 80), density=0.08)


def _instances(seed, shape, density):
    out = []
    for inst_cls, rs in ((JaxInstance, jax_random_structure), (SpGEMMInstance, random_structure)):
        rng = np.random.default_rng(seed)
        a = rs(shape[0], shape[1], density, rng)
        b = rs(shape[1], shape[2], density, rng)
        out.append(inst_cls(a, b))
    return out


def _hypergraphs(model, seed=0, family=LARGE):
    ji, ti = _instances(seed, **family)
    return jax_build_model(ji, model), build_model(ti, model)


def _cap(hg, p, eps=0.10):
    w = hg.w_comp.astype(np.float64)
    return max((1 + eps) * w.sum() / p, float(w.max()))


@pytest.fixture
def device_everywhere(monkeypatch):
    """Route every size through the device engine, in both packages."""
    monkeypatch.setattr(jax_partition_mod, "DEVICE_MIN_VERTICES", 0)
    monkeypatch.setattr(partition_mod, "DEVICE_MIN_VERTICES", 0)
    monkeypatch.setattr(jax_partition_mod, "_FALLBACK_WARNED", set())


# ---------------------------------------------------------------------------
# the pieces, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("salt", [0, 1, 0x85EBCA77, 0xDEADBEEF, 0xFFFFFFFF])
def test_hash_bit_for_bit(salt):
    x = np.arange(10**6, dtype=np.uint32) * np.uint32(0x9E3779B9)  # spread over 32 bits
    want = np.asarray(jax_rd._hash_u32(jnp.asarray(x), jnp.uint32(salt)))
    got = rd._hash_u32(torch.as_tensor(x.astype(np.int64)), salt)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("model", ["rowwise", "fine", "monoC"])
def test_pad_level_arrays_equal(model):
    jh, th = _hypergraphs(model, seed=1, family=SMALL)
    for bucket_j, bucket_t in ((None, None), (jax_cd._bucket_fine, cd._bucket_fine)):
        pj = jax_rd._pad_level(jh, bucket=bucket_j)
        pt = rd._pad_level(th, bucket=bucket_t, device="cpu")
        assert (pj.nb, pj.mb, pj.pb) == (pt.nb, pt.mb, pt.pb)
        assert len(pt.args) == 13
        for a, b in zip(pj.args, pt.args):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(pt.vinv.numpy(), np.asarray(pj.vinv))
    assert rd._bucket(10**6) == jax_rd._bucket(10**6)
    assert cd._bucket_fine(10**6 + 1) == jax_cd._bucket_fine(10**6 + 1)


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("model", ["rowwise", "fine"])
def test_refine_batch_labels_and_scores_equal_jax(model, p):
    jh, th = _hypergraphs(model, seed=1, family=SMALL)
    cap = _cap(th, p)
    init = jax_rd.initial_partitions(jh, p, seed=3)
    np.testing.assert_array_equal(rd.initial_partitions(th, p, seed=3), init)
    want_b, want_s = jax_rd.refine_batch(jh, init, p, cap, 8, seed=3, salt=1)
    got_b, got_s = rd.refine_batch(th, init, p, cap, 8, seed=3, salt=1, device="cpu")
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_s, want_s)
    assert got_s.dtype == np.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_coarsen_level_maps_and_levels_equal_jax(seed):
    jh, th = _hypergraphs("rowwise", seed=seed)
    cap = max(float(th.w_comp.sum()) / 12.0, float(th.w_comp.max()))
    lj, lt = jax_cd.finest_level(jh), cd.finest_level(th, "cpu")
    depth = 0
    for index in range(3):
        oj = jax_cd.coarsen_level(lj, cap, seed=seed, index=index)
        ot = cd.coarsen_level(lt, cap, seed=seed, index=index)
        assert (oj is None) == (ot is None)
        if oj is None:
            break
        (cj, mj, nj), (ct, mt, nt) = oj, ot
        assert nt == nj and (ct.nb, ct.mb, ct.pb, ct.n_vertices) == (
            cj.nb, cj.mb, cj.pb, cj.n_vertices)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        for a, b in zip(cj.args, ct.args):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(ct.vinv.numpy(), np.asarray(cj.vinv))
        # a genuine contraction: coarse weights are the fine weights summed
        w = np.asarray(lt.args[3].numpy(), np.float64)[: lt.n_vertices]
        summed = np.bincount(mt.numpy()[: lt.n_vertices], weights=w, minlength=nt)
        np.testing.assert_array_equal(ct.args[3].numpy()[:nt], summed)
        lj, lt = cj, ct
        depth += 1
    assert depth >= 2


# ---------------------------------------------------------------------------
# the whole engine, bit for bit
# ---------------------------------------------------------------------------
_ENGINE_CASES = [
    ("rowwise", LARGE, 0),
    ("fine", SMALL, 1),
    ("monoC", SMALL, 4),
]


@pytest.mark.parametrize("coarsen", ["auto", "device", "host"])
@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("model,family,seed", _ENGINE_CASES)
def test_partition_labels_equal_jax(device_everywhere, model, family, seed, p, coarsen):
    jh, th = _hypergraphs(model, seed=seed, family=family)
    assert cd.packs_finest(th)  # below the guard "auto" is the resident descend
    want = jax_partition(jh, p, eps=0.10, seed=seed, engine="device", coarsen=coarsen)
    got = partition(th, p, eps=0.10, seed=seed, engine="device", coarsen=coarsen,
                    device="cpu")
    np.testing.assert_array_equal(got.parts, want.parts)
    assert got.connectivity == want.connectivity
    assert got.connectivity == evaluate(th, got.parts, p).connectivity
    assert set(got.phases) == {"coarsen_s", "refine_s", "polish_s"}
    assert got.descend == ("host" if coarsen == "host" else "device")


@pytest.mark.parametrize("model,family,seed", _ENGINE_CASES)
def test_packs_finest_reads_the_finest_levels_shape(monkeypatch, model, family, seed):
    """``packs_finest`` reads, without building the level, the guard that
    ``coarsen_level`` applies to ``finest_level``'s padded shape."""
    _, th = _hypergraphs(model, seed=seed, family=family)
    lvl = cd.finest_level(th, "cpu")
    key_span = lvl.nb * lvl.pb
    assert cd.packs_finest(th) == (key_span < cd._INT31 - 1)
    for bound, packs in ((key_span + 1, False), (key_span + 2, True)):
        monkeypatch.setattr(cd, "_INT31", bound)
        assert cd.packs_finest(th) is packs
        assert (cd.coarsen_level(lvl, float(th.w_comp.sum()), 0, 0) is None) or packs


@pytest.fixture
def guard_tripped(device_everywhere, monkeypatch):
    """Put every finest level past the int32 sort-key guard, in both
    packages, as at full size (27-AP, 27-PTAP, LP-pds100 monoC)."""
    monkeypatch.setattr(jax_cd, "_INT31", 2)
    monkeypatch.setattr(cd, "_INT31", 2)
    calls = []
    coarsen_level = cd.coarsen_level

    def counted(*args, **kwargs):
        out = coarsen_level(*args, **kwargs)
        calls.append(out is None)
        return out

    monkeypatch.setattr(cd, "coarsen_level", counted)
    return calls


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("model,family,seed", [("rowwise", LARGE, 0), ("monoC", LARGE, 4)])
def test_descent_stopped_by_the_guard_equals_jax(guard_tripped, model, family, seed, p):
    """Past the guard the reference's resident descent stops before its
    first level and refines the finest level alone; the port's
    ``coarsen="device"`` does the same, label for label."""
    jh, th = _hypergraphs(model, seed=seed, family=family)
    want = jax_partition(jh, p, eps=0.10, seed=seed, engine="device", coarsen="auto")
    got = partition(th, p, eps=0.10, seed=seed, engine="device", coarsen="device",
                    device="cpu")
    assert guard_tripped == [True]  # one coarsen_level call, refused by the guard
    assert got.descend == "device" and got.phases is not None
    np.testing.assert_array_equal(got.parts, want.parts)
    assert got.connectivity == want.connectivity


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("model,family,seed", [("rowwise", LARGE, 0), ("monoC", LARGE, 4)])
def test_auto_takes_the_host_descend_past_the_guard(guard_tripped, model, family, seed, p):
    """Deliberate difference: where the guard stops the resident descent
    before its first step, the port's ``coarsen="auto"`` takes the host
    descend — JAX's ``coarsen="host"`` labels — and never calls
    ``coarsen_level``."""
    jh, th = _hypergraphs(model, seed=seed, family=family)
    assert not cd.packs_finest(th)
    want = jax_partition(jh, p, eps=0.10, seed=seed, engine="device", coarsen="host")
    got = partition(th, p, eps=0.10, seed=seed, engine="device", coarsen="auto",
                    device="cpu")
    assert guard_tripped == []
    assert got.descend == "host" and got.phases is not None
    np.testing.assert_array_equal(got.parts, want.parts)
    assert got.connectivity == want.connectivity


@pytest.mark.parametrize("model", ["rowwise", "monoC"])
def test_front_door_device_engine_equals_jax(device_everywhere, model):
    ji, ti = _instances(2, **SMALL)
    hj = repro.plan(ji, p=4, model=model, engine="device")
    ht = repro_torch.plan(ti, p=4, model=model, engine="device", device="cpu")
    np.testing.assert_array_equal(ht.partition.parts, hj.partition.parts)
    assert ht.partition.phases is not None
    assert ht.cost_report() == hj.cost_report()
    exe = ht.compile(device="cpu")
    a = np.ones(ti.a.nnz, np.float32)
    b = np.ones(ti.b.nnz, np.float32)
    dense = lambda s: s.csr.toarray().astype(np.float32)  # noqa: E731
    np.testing.assert_allclose(exe(a, b).numpy(), dense(ti.a) @ dense(ti.b),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine's own contracts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("coarsen", ["auto", "host"])
@pytest.mark.parametrize("p,eps", [(2, 0.05), (4, 0.10), (8, 0.10)])
def test_balance_cap_respected(device_everywhere, p, eps, coarsen):
    _, th = _hypergraphs("rowwise", seed=3)
    res = partition(th, p, eps=eps, seed=0, engine="device", coarsen=coarsen, device="cpu")
    w = th.w_comp.astype(np.float64)
    part_w = np.bincount(res.parts, weights=w, minlength=p)
    assert (part_w <= _cap(th, p, eps) + 1e-9).all()


def test_deterministic_for_fixed_seed(device_everywhere):
    _, th = _hypergraphs("rowwise", seed=4)
    a = partition(th, 4, eps=0.10, seed=5, engine="device", device="cpu")
    b = partition(th, 4, eps=0.10, seed=5, engine="device", device="cpu")
    np.testing.assert_array_equal(a.parts, b.parts)
    assert a.connectivity == b.connectivity


def test_defers_to_flat_below_threshold():
    """Without the monkeypatch, sub-threshold instances (and p = 1) take the
    flat quality path bit for bit, with no device phases."""
    _, th = _hypergraphs("rowwise", seed=0, family=SMALL)
    assert th.n_vertices <= partition_mod.DEVICE_MIN_VERTICES
    dev = partition(th, 4, eps=0.10, seed=0, engine="device", device="cpu")
    flat = partition(th, 4, eps=0.10, seed=0, engine="flat")
    np.testing.assert_array_equal(dev.parts, flat.parts)
    assert dev.phases is None and flat.phases is None


def test_p1_defers_to_flat(device_everywhere):
    _, th = _hypergraphs("rowwise", seed=0, family=SMALL)
    res = partition(th, 1, seed=0, engine="device", device="cpu")
    assert res.phases is None and not res.parts.any()


@pytest.mark.parametrize("coarsen", ["auto", "host"])
def test_failing_device_step_raises_where_jax_falls_back(device_everywhere, monkeypatch,
                                                         coarsen):
    """Deliberate difference: the reference warns and degrades (to host
    coarsening, or to the flat engine); the port raises."""
    jh, th = _hypergraphs("rowwise", seed=0)

    def broken(*args, **kwargs):
        raise RuntimeError("device step failed")

    monkeypatch.setattr(jax_rd, "refine_args", broken)
    monkeypatch.setattr(jax_rd, "refine_batch", broken)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref = jax_partition(jh, 4, eps=0.10, seed=0, engine="device", coarsen=coarsen)
    assert ref.phases is None  # JAX fell back to its flat engine, with a warning
    assert any("falling back" in str(w.message) for w in caught)
    monkeypatch.setattr(rd, "refine_args", broken)
    with pytest.raises(RuntimeError, match="device step failed"):
        partition(th, 4, eps=0.10, seed=0, engine="device", coarsen=coarsen, device="cpu")


def test_failing_device_coarsening_raises(device_everywhere, monkeypatch):
    _, th = _hypergraphs("rowwise", seed=0)

    def broken(*args, **kwargs):
        raise RuntimeError("device coarsening failed")

    monkeypatch.setattr(cd, "coarsen_level", broken)
    with pytest.raises(RuntimeError, match="device coarsening failed"):
        partition(th, 4, eps=0.10, seed=0, engine="device", device="cpu")
    # the host descend does not touch it
    assert partition(th, 4, eps=0.10, seed=0, engine="device", coarsen="host",
                     device="cpu").phases is not None


def test_device_engine_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot show")
    _, th = _hypergraphs("rowwise", seed=0, family=SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        partition(th, 4, engine="device")


def test_session_device_engine_reports_no_fallback(device_everywhere):
    ji, ti = _instances(5, **SMALL)
    dense = lambda s: s.csr.toarray().astype(np.float32)  # noqa: E731
    A, B = dense(ti.a), dense(ti.b)
    s = repro_torch.session(p=4, model="rowwise", engine="device", device="cpu",
                            policy=FaultPolicy(max_retries=0, backoff_s=0.0))
    np.testing.assert_allclose(s.multiply(A, B).numpy(), A @ B, rtol=1e-5, atol=1e-5)
    assert [e.kind for e in s.events] == ["cold_replan"]
    planned = next(iter(s._pool.values())).planned
    assert planned.partition.phases is not None
    want = jax_partition(jax_build_model(ji, "rowwise"), 4, eps=0.10, seed=0,
                         engine="device")
    np.testing.assert_array_equal(planned.partition.parts, want.parts)
