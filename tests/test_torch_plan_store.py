"""The port's plan store (``repro_torch.checkpoint``) against the JAX
package's: one on-disk format, so a plan either package stores restores in
the other with equal plan arrays and ``plan_fingerprint`` (the identity the
executor LRU keys on); atomic commits, checksum and version quarantine; and
the reference's ``SummaPlan`` entries, which restore and execute in the port.
The session's store keys equal the reference's for the same operands.
"""
import json
import os
import shutil

import numpy as np
import pytest

import repro
import repro_torch
from repro.api import _plan_one as jax_plan_one
from repro.checkpoint import restore_plan as jax_restore_plan
from repro.checkpoint import save_plan as jax_save_plan
from repro.core import SpGEMMInstance as JaxInstance
from repro.distributed.runtime import plan_fingerprint as jax_fingerprint
from repro.resilience import FaultPolicy as JaxFaultPolicy
from repro.sparse.structure import from_dense as jax_from_dense
from repro.sparse.structure import structure_fingerprint as jax_structure_fingerprint
from repro_torch.api import _plan_one
from repro_torch.checkpoint import (
    PLAN_STORE_VERSION,
    PlanStoreError,
    list_plans,
    restore_plan,
    save_plan,
)
from repro_torch.core.spgemm_models import SpGEMMInstance
from repro_torch.distributed.runtime import plan_fingerprint
from repro_torch.resilience import FaultPolicy
from repro_torch.sparse.structure import from_dense, structure_fingerprint
from test_torch_planning import _same_plan

MODELS = repro_torch.executable_models()


def _masks(seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((30, 26)) < 0.15, rng.random((26, 28)) < 0.15


def _planned(model, seed=0):
    a, b = _masks(seed)
    return _plan_one(SpGEMMInstance(from_dense(a), from_dense(b)), model, 2, 0.10, 0,
                     False, "flat")


def _jax_planned(model, seed=0):
    a, b = _masks(seed)
    return jax_plan_one(JaxInstance(jax_from_dense(a), jax_from_dense(b)), model, 2, 0.10,
                        0, include_nz=False)


# ---------------------------------------------------------------------------
# round trips, within the port and across the two packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", MODELS)
def test_roundtrip_preserves_plan_fingerprint(model, tmp_path):
    plan = _planned(model).execution_plan
    store = str(tmp_path / "store")
    save_plan(store, f"k_{model}", plan)
    back = restore_plan(store, f"k_{model}")
    assert type(back.plan) is type(plan)
    assert back.plan.model == plan.model and back.plan.p == plan.p
    assert back.plan.stats == {k: int(v) for k, v in plan.stats.items()}
    _same_plan(plan, back.plan)
    assert plan_fingerprint(back.plan) == plan_fingerprint(plan)


@pytest.mark.parametrize("model", MODELS)
def test_jax_stored_plan_restores_in_the_port(model, tmp_path):
    ref = _jax_planned(model).execution_plan
    store = str(tmp_path / "store")
    jax_save_plan(store, "k", ref, arrays={"labels": np.arange(5)}, meta={"model": model})
    back = restore_plan(store, "k")
    assert type(back.plan).__name__ == type(ref).__name__
    _same_plan(ref, back.plan)
    assert plan_fingerprint(back.plan) == jax_fingerprint(ref)
    np.testing.assert_array_equal(back.arrays["labels"], np.arange(5))
    assert back.meta == {"model": model}


@pytest.mark.parametrize("model", MODELS)
def test_port_stored_plan_restores_in_jax(model, tmp_path):
    plan = _planned(model).execution_plan
    store = str(tmp_path / "store")
    save_plan(store, "k", plan, meta={"p": 2})
    back = jax_restore_plan(store, "k")
    assert type(back.plan).__name__ == type(plan).__name__
    _same_plan(back.plan, plan)
    assert jax_fingerprint(back.plan) == plan_fingerprint(plan)
    assert back.meta == {"p": 2}


def test_summa_entry_is_not_yet_ported_and_not_quarantined(tmp_path):
    """A JAX ``SummaPlan`` entry restores in the port (no longer refused as
    "not yet ported"), intact and unquarantined, and executes to A @ B."""
    a, b = _masks(1)
    summa = repro.plan(jax_from_dense(a), jax_from_dense(b), p=4, model="summa2d")
    store = str(tmp_path / "store")
    jax_save_plan(store, "summa", summa.execution_plan)
    back = restore_plan(store, "summa")
    assert type(back.plan).__name__ == "SummaPlan"
    _same_plan(summa.execution_plan, back.plan)
    assert plan_fingerprint(back.plan) == jax_fingerprint(summa.execution_plan)
    assert list_plans(store) == ["summa"]  # intact: no quarantine
    assert not any("quarantined" in d for d in os.listdir(store))
    a_s, b_s = from_dense(a), from_dense(b)
    exe = restore_compile(back.plan, a_s, b_s)
    np.testing.assert_allclose(
        exe(np.ones(a_s.nnz, np.float32), np.ones(b_s.nnz, np.float32)).numpy(),
        a.astype(np.float32) @ b.astype(np.float32), rtol=1e-5, atol=1e-5,
    )


def restore_compile(plan, a_s, b_s):
    """A restored plan compiled on the CPU through the front door's handle."""
    from repro_torch.api import PlannedSpGEMM

    inst = SpGEMMInstance(a_s, b_s)
    return PlannedSpGEMM(instance=inst, model=plan.model, hypergraph=None, partition=None,
                         execution_plan=plan).compile(device="cpu")


def test_session_store_keys_equal_jax(tmp_path):
    """Both sessions save the same operands under the same key, so their
    stores can be shared."""
    a, b = _masks(2)
    A = (a * 1.5).astype(np.float32)
    B = (b * 0.5).astype(np.float32)
    assert structure_fingerprint(from_dense(A)) == jax_structure_fingerprint(jax_from_dense(A))
    port_store, jax_store = str(tmp_path / "port"), str(tmp_path / "jax")
    repro_torch.session(p=1, model="rowwise", device="cpu", store_dir=port_store,
                        policy=FaultPolicy(backoff_s=0.0)).multiply(A, B)
    repro.session(p=1, model="rowwise", store_dir=jax_store,
                  policy=JaxFaultPolicy(backoff_s=0.0)).multiply(A, B)
    assert list_plans(port_store) == list_plans(jax_store) != []


def test_session_restores_a_jax_stored_pool(tmp_path):
    """A JAX session's store seeds a port session: restored, not replanned."""
    a, b = _masks(3)
    A, B = a.astype(np.float32), b.astype(np.float32)
    store = str(tmp_path / "store")
    repro.session(p=1, model="fine", store_dir=store,
                  policy=JaxFaultPolicy(backoff_s=0.0)).multiply(A, B)
    s = repro_torch.session(p=1, model="fine", device="cpu", store_dir=store,
                            policy=FaultPolicy(backoff_s=0.0))
    np.testing.assert_allclose(s.multiply(A, B).numpy(), A @ B, rtol=1e-5, atol=1e-5)
    assert [e.kind for e in s.events] == ["restored"]


# ---------------------------------------------------------------------------
# the store's own contract (as the reference's tests hold it)
# ---------------------------------------------------------------------------
def test_roundtrip_preserves_extra_arrays_and_meta(tmp_path):
    plan = _planned("rowwise").execution_plan
    store = str(tmp_path / "store")
    labels = np.arange(30) % 2
    save_plan(store, "k", plan, arrays={"labels": labels}, meta={"p": 2, "m": "x"})
    back = restore_plan(store, "k")
    np.testing.assert_array_equal(back.arrays["labels"], labels)
    assert back.meta == {"p": 2, "m": "x"}


def test_missing_entry_and_bad_key(tmp_path):
    assert restore_plan(str(tmp_path), "nothere") is None
    assert list_plans(str(tmp_path / "void")) == []
    plan = _planned("rowwise").execution_plan
    with pytest.raises(ValueError, match="plan key"):
        save_plan(str(tmp_path), "../escape", plan)
    with pytest.raises(ValueError, match="plan key"):
        restore_plan(str(tmp_path), "a/b")


def test_tmp_and_quarantined_dirs_are_invisible(tmp_path):
    store = str(tmp_path / "store")
    save_plan(store, "good", _planned("rowwise").execution_plan)
    os.makedirs(os.path.join(store, "half.tmp"))  # crash mid-write
    os.makedirs(os.path.join(store, "bad.quarantined-0"))
    assert list_plans(store) == ["good"]
    assert restore_plan(store, "half") is None


def test_interrupted_overwrite_recovers_previous_entry(tmp_path):
    store = str(tmp_path / "store")
    plan = _planned("rowwise").execution_plan
    save_plan(store, "k", plan, meta={"gen": 1})
    # crash window: old renamed aside, new never landed
    os.rename(os.path.join(store, "k"), os.path.join(store, "k.prev"))
    assert list_plans(store) == ["k"]  # the reader promotes the .prev back
    assert restore_plan(store, "k").meta == {"gen": 1}
    # an overwrite commits atomically and drops any stale .prev
    save_plan(store, "k", plan, meta={"gen": 2})
    shutil.copytree(os.path.join(store, "k"), os.path.join(store, "k.prev"))
    assert restore_plan(store, "k").meta == {"gen": 2}
    assert not os.path.exists(os.path.join(store, "k.prev"))


def _corrupt_arrays(store, key):
    blob = os.path.join(store, key, "arrays.npz")
    raw = bytearray(open(blob, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(blob, "wb").write(bytes(raw))


def test_checksum_mismatch_quarantines(tmp_path):
    store = str(tmp_path / "store")
    save_plan(store, "k", _planned("monoC").execution_plan)
    _corrupt_arrays(store, "k")
    with pytest.warns(RuntimeWarning, match="quarantined 'k'.*checksum"):
        assert restore_plan(store, "k") is None
    assert list_plans(store) == []
    assert os.path.isdir(os.path.join(store, "k.quarantined-0"))


def test_version_mismatch_quarantines(tmp_path):
    store = str(tmp_path / "store")
    save_plan(store, "k", _planned("rowwise").execution_plan)
    man = os.path.join(store, "k", "manifest.json")
    with open(man) as f:
        manifest = json.load(f)
    manifest["version"] = PLAN_STORE_VERSION + 1
    with open(man, "w") as f:
        json.dump(manifest, f)
    with pytest.warns(RuntimeWarning, match="version"):
        assert restore_plan(store, "k") is None
    assert list_plans(store) == []


def test_quarantine_false_raises_instead(tmp_path):
    store = str(tmp_path / "store")
    save_plan(store, "k", _planned("rowwise").execution_plan)
    _corrupt_arrays(store, "k")
    with pytest.raises(PlanStoreError, match="checksum"):
        restore_plan(store, "k", quarantine=False)
    assert list_plans(store) == ["k"]  # untouched: the caller decides


def test_repeated_corruption_gets_numbered_quarantines(tmp_path):
    store = str(tmp_path / "store")
    plan = _planned("rowwise").execution_plan
    for n in range(2):
        save_plan(store, "k", plan)
        _corrupt_arrays(store, "k")
        with pytest.warns(RuntimeWarning):
            restore_plan(store, "k")
        assert os.path.isdir(os.path.join(store, f"k.quarantined-{n}"))
