"""The port's resilient session on the CPU (``repro_torch.session``), held to
the JAX package's on the same scripted traffic: the event sequence (kinds
and models), the warm-start labels bit for bit, the pool's LRU bound, and
the fault policy at every stage boundary — transient faults retried, a
permanent execute fault downgrading the model (a failed kernel raising
instead), a store failure costing no multiply, a killed session restoring
without replanning, a corrupt entry quarantined.

JAX sees one CPU device in this process, so the p = 4 reference run happens
in one subprocess with four forced host devices.
"""
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.distributed import session as jax_session
from repro.resilience import FaultPolicy as JaxFaultPolicy
from repro_torch.checkpoint import list_plans
from repro_torch.core.spgemm_models import SpGEMMInstance
from repro_torch.distributed import runtime
from repro_torch.distributed import session as torch_session
from repro_torch.kernels import KernelError
from repro_torch.resilience import FaultPolicy, is_retryable
from repro_torch.sparse.structure import from_dense
from repro_torch.testing import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = FaultPolicy(max_retries=2, backoff_s=0.0)
JAX_FAST = JaxFaultPolicy(max_retries=2, backoff_s=0.0)
TOL = dict(rtol=2e-4, atol=2e-4)
TOL_JAX = dict(rtol=1e-5, atol=1e-5)


def _mats(seed=0, shape=(14, 12, 13), density=0.35):
    rng = np.random.default_rng(seed)
    A = rng.random(shape[:2]) * (rng.random(shape[:2]) < density)
    B = rng.random(shape[1:]) * (rng.random(shape[1:]) < density)
    # no empty rows/cols on the contraction axis (keeps products non-trivial)
    A[np.arange(shape[0]), rng.integers(0, shape[1], shape[0])] = 1.0
    B[np.arange(shape[1]), rng.integers(0, shape[2], shape[1])] = 1.0
    return A.astype(np.float32), B.astype(np.float32)


def _drift(M, seed=1, frac=0.15):
    """Drop some nonzeros and add as many new ones, in the same shape."""
    rng = np.random.default_rng(seed)
    out = M.copy()
    nz = np.flatnonzero(out)
    drop = rng.choice(nz, max(1, int(frac * len(nz))), replace=False)
    out.flat[drop] = 0.0
    z = np.flatnonzero(out == 0)
    add = rng.choice(z, max(1, int(frac * len(nz))), replace=False)
    out.flat[add] = rng.random(len(add)).astype(np.float32) + 0.1
    return out


def _session(**kw):
    kw.setdefault("policy", FAST)
    return repro_torch.session(device="cpu", **kw)


def _kinds(s):
    return [e.kind for e in s.events]


def _events(s):
    return [(e.kind, e.model) for e in s.events]


def _check(s, A, B):
    C = s.multiply(A, B)
    assert isinstance(C, torch.Tensor) and C.device.type == "cpu"
    np.testing.assert_allclose(C.numpy(), A @ B, **TOL)
    return C


def _traffic():
    """Scripted traffic: a structure, a value change, a drift, a shape
    change, and the first structure again."""
    A, B = _mats(1)
    A2 = _drift(A, seed=2)
    return [(A, B), (2 * A, B), (A2, B), _mats(3, shape=(20, 12, 13)), (A, B)]


# ---------------------------------------------------------------------------
# the same traffic through both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["rowwise", "fine", "monoC", "auto"])
def test_events_equal_jax_at_p1(model):
    port = _session(p=1, model=model)
    ref = repro.session(p=1, model=model, policy=JAX_FAST)
    for A, B in _traffic():
        got = _check(port, A, B)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref.multiply(A, B)), **TOL_JAX)
    assert _events(port) == _events(ref)
    assert port.stats() == ref.stats()
    assert [e.detail for e in port.events] == [e.detail for e in ref.events]


def test_pool_lru_bound_equals_jax():
    port = _session(p=1, model="rowwise", max_entries=2)
    ref = repro.session(p=1, model="rowwise", policy=JAX_FAST, max_entries=2)
    for seed in (0, 1, 2, 3, 0):
        A, B = _mats(seed)
        _check(port, A, B)
        ref.multiply(A, B)
    assert port.stats()["pool_size"] == 2
    assert _events(port) == _events(ref)
    assert _kinds(port).count("evict") == 3


@pytest.mark.parametrize("model", ["rowwise", "outer", "fine", "monoC"])
def test_warm_labels_equal_jax_at_p4(model):
    """The drifted structure's warm start, vertex keys and label carry-over
    included, equals the reference's bit for bit (planning needs no device)."""
    from repro.api import _plan_one as jax_plan_one
    from repro.core.spgemm_models import SpGEMMInstance as JaxInstance
    from repro.sparse.structure import from_dense as jax_from_dense
    from repro_torch.api import _plan_one

    A, B = _mats(5, shape=(30, 26, 28), density=0.2)
    A2 = _drift(A, seed=6, frac=0.05)
    old_t = SpGEMMInstance(from_dense(A), from_dense(B))
    new_t = SpGEMMInstance(from_dense(A2), from_dense(B))
    old_j = JaxInstance(jax_from_dense(A), jax_from_dense(B))
    new_j = JaxInstance(jax_from_dense(A2), jax_from_dense(B))
    cold_t = _plan_one(old_t, model, 4, 0.10, 0, False, "flat")
    cold_j = jax_plan_one(old_j, model, 4, 0.10, 0, include_nz=False)
    np.testing.assert_array_equal(cold_t.partition.parts, cold_j.partition.parts)
    keys_t = torch_session._vertex_keys(new_t, model)
    np.testing.assert_array_equal(keys_t, jax_session._vertex_keys(new_j, model))
    old_keys = torch_session._vertex_keys(old_t, model)
    labels_t = torch_session._map_labels(old_keys, cold_t.partition.parts, keys_t)
    labels_j = jax_session._map_labels(
        jax_session._vertex_keys(old_j, model), cold_j.partition.parts, keys_t
    )
    np.testing.assert_array_equal(labels_t, labels_j)
    warm_t = _plan_one(new_t, model, 4, 0.10, 0, False, "flat", warm_start=labels_t)
    warm_j = jax_plan_one(new_j, model, 4, 0.10, 0, include_nz=False, warm_start=labels_j)
    assert warm_t.partition.warm and warm_j.partition.warm
    np.testing.assert_array_equal(warm_t.partition.parts, warm_j.partition.parts)
    assert warm_t.partition.connectivity == warm_j.partition.connectivity


def test_warm_start_falls_back_cold_past_the_drift_limit():
    partition = importlib.import_module("repro_torch.core.partition")
    A, B = _mats(7, shape=(30, 26, 28), density=0.2)
    hg = repro_torch.plan(A, B, p=4, model="rowwise").hypergraph
    labels = np.full(hg.n_vertices, -1)
    labels[: hg.n_vertices // 4] = 0
    res = partition.partition(hg, 4, eps=0.10, warm_start=labels, warm_drift_limit=0.5)
    assert not res.warm  # 75% unmapped: cold
    cold = partition.partition(hg, 4, eps=0.10)
    np.testing.assert_array_equal(res.parts, cold.parts)


_JAX_P4 = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, repro
from repro.resilience import FaultPolicy
d = np.load(sys.argv[1])
out = {}
for model in ("monoC", "fine", "rowwise"):
    s = repro.session(p=4, model=model, policy=FaultPolicy(backoff_s=0.0), max_entries=2)
    for i in range(len(d.files)):
        X = d[f"m{i}"]
        out[f"{model}/C{i}"] = np.asarray(s.multiply(X, X)).tolist()
    out[f"{model}/events"] = [[e.kind, e.model, e.detail.get("drift")] for e in s.events]
    out[f"{model}/labels"] = {k: e.labels.tolist() for k, e in s._pool.items()}
json.dump(out, open(sys.argv[2], "w"))
"""


def _mcl_structures(n=40, steps=4):
    """An MCL-style expand-and-prune chain: the structure drifts every step."""
    rng = np.random.default_rng(5)
    M = (rng.random((n, n)) * (rng.random((n, n)) < 0.2)).astype(np.float32)
    M[np.arange(n), np.arange(n)] = 1.0
    out = []
    for _ in range(steps):
        out.append(M)
        C = M @ M
        C[C < np.quantile(C[C > 0], 0.3)] = 0.0
        col = C.sum(axis=0)
        M = (C / np.where(col > 0, col, 1.0)).astype(np.float32)
        M[np.arange(n), np.arange(n)] += 0.5
    return out + [out[0]]


@pytest.fixture(scope="module")
def jax_p4(tmp_path_factory):
    """The JAX package's p = 4 sessions over the MCL chain."""
    tmp = tmp_path_factory.mktemp("jax_p4_session")
    mats = _mcl_structures()
    np.savez(tmp / "in.npz", **{f"m{i}": m for i, m in enumerate(mats)})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _JAX_P4, str(tmp / "in.npz"), str(tmp / "out.json")],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return mats, json.loads((tmp / "out.json").read_text())


@pytest.mark.parametrize("model", ["monoC", "fine", "rowwise"])
def test_drift_chain_equals_jax_at_p4(jax_p4, model):
    mats, ref = jax_p4
    s = _session(p=4, model=model, max_entries=2)
    for i, X in enumerate(mats):
        got = _check(s, X, X)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref[f"{model}/C{i}"]), **TOL_JAX)
    events = [[e.kind, e.model, e.detail.get("drift")] for e in s.events]
    assert events == ref[f"{model}/events"]
    assert "warm_replan" in [e[0] for e in events] and "evict" in [e[0] for e in events]
    labels = {k: e.labels.tolist() for k, e in s._pool.items()}
    assert labels == ref[f"{model}/labels"]  # bit for bit, keys included


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------
def test_unchanged_structure_hits_warm_pool():
    A, B = _mats(0)
    s = _session(p=4, model="monoC")
    _check(s, A, B)
    misses = runtime.cache_info()["misses"]
    _check(s, A * 2.0, B)
    assert _kinds(s) == ["cold_replan", "hit"]
    assert runtime.cache_info()["misses"] == misses
    assert s.stats()["pool_size"] == 1


def test_engine_device_falls_back_to_flat():
    """The port has no device partitioner: asking for it takes the policy's
    engine chain down to "flat", recorded as an engine_fallback event."""
    A, B = _mats(40)
    s = _session(p=4, model="rowwise", engine="device")
    _check(s, A, B)
    assert _kinds(s) == ["engine_fallback", "cold_replan"]
    assert s.events[0].detail["engine"] == "flat"
    assert "not ported yet" in s.events[0].detail["error"]


def test_session_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.session(p=4)


def test_cuda_errors_classify_as_the_reference_does():
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert is_retryable(oom)
    assert not is_retryable(RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert not is_retryable(ValueError("shape mismatch"))


# ---------------------------------------------------------------------------
# fault injection: every stage boundary, transient and permanent
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stage", faults.STAGES)
def test_transient_fault_at_each_stage_is_retried(stage, tmp_path):
    """One multiply touches all five boundaries (empty store: restore is
    attempted, returns nothing, plan is saved).  A transient failure at any
    one of them must be retried and leave the result correct."""
    A, B = _mats(10 + list(faults.STAGES).index(stage))  # defeat executor LRU
    s = _session(p=4, model="monoC", store_dir=str(tmp_path / "store"))
    with faults.inject(stage, times=1) as script:
        _check(s, A, B)
    assert script.fired == 1, f"fault at {stage!r} never fired"
    retried = [e for e in s.events if e.kind == "retry" and e.detail["stage"] == stage]
    assert len(retried) == 1
    assert "saved" in _kinds(s)


def test_permanent_execute_failure_downgrades_model():
    A, B = _mats(20)
    s = _session(p=4, model="fine")
    with faults.inject("execute", exc=ValueError, times=1) as script:
        _check(s, A, B)
    assert script.fired == 1
    down = next(e for e in s.events if e.kind == "model_downgrade")
    assert (down.detail["from_model"], down.model) == ("fine", "monoC")
    assert s.stats()["model"] == "monoC"
    _check(s, A, B)  # the downgraded entry is the warm one now
    assert _kinds(s)[-1] == "hit"


@pytest.mark.parametrize("stage", ["compile", "execute", "restored compile"])
def test_kernel_failure_is_raised_not_downgraded(stage, tmp_path):
    """A kernel of the port that fails on the card (``KernelError``: no
    build, no load, refused inputs, a failed launch) is raised: no model
    downgrade, no replan around a stored plan, no retry."""
    A, B = _mats(22)
    store = str(tmp_path / "store")
    if stage == "restored compile":
        _check(_session(p=4, model="monoC", store_dir=store), A, B)
        runtime._CACHE.clear()  # the restore must build its executor
    s = _session(p=4, model="monoC", store_dir=store)
    with faults.inject(stage.split()[-1], exc=KernelError, times=1) as script:
        with pytest.raises(KernelError):
            s.multiply(A, B)
    assert script.fired == 1
    assert not {"model_downgrade", "store_error", "retry"} & set(_kinds(s))


def test_permanent_store_failure_is_nonfatal(tmp_path):
    A, B = _mats(21)
    store = str(tmp_path / "store")
    s = _session(p=4, model="rowwise", store_dir=store)
    with faults.inject("store_save", exc=ValueError, times=1):
        _check(s, A, B)  # persistence lost, multiply unharmed
    ev = next(e for e in s.events if e.kind == "store_error")
    assert ev.detail["op"] == "save"
    assert "saved" not in _kinds(s)
    assert list_plans(store) == []


def test_mcl_style_loop_survives_scripted_faults(tmp_path):
    """Expand-and-prune iterations (the structure drifts every step) with
    failures scripted at four boundaries, every product checked."""
    s = _session(p=4, model="monoC", store_dir=str(tmp_path / "store"))
    schedule = {"partition": [1], "execute": [2], "store_save": [0], "compile": [1]}
    with faults.scripted(schedule) as scripts:
        for M in _mcl_structures(n=16)[:4]:
            _check(s, M, M)
    for stage, script in scripts.items():
        assert script.fired == len(schedule[stage]), f"{stage} fault never fired"
    kinds = _kinds(s)
    assert kinds.count("cold_replan") + kinds.count("warm_replan") == 4
    assert kinds.count("retry") == 4


# ---------------------------------------------------------------------------
# persistence: kill-and-restore, corruption quarantine
# ---------------------------------------------------------------------------
def test_killed_session_restores_without_replanning(tmp_path):
    store = str(tmp_path / "store")
    A, B = _mats(30)
    s1 = _session(p=4, model="monoC", store_dir=store)
    want = _check(s1, A, B)
    assert "saved" in _kinds(s1)
    del s1  # the crash

    s2 = _session(p=4, model="monoC", store_dir=store)
    faults.reset_counts()
    misses = runtime.cache_info()["misses"]
    got = _check(s2, A, B)
    assert faults.call_counts().get("partition", 0) == 0
    # the restored plan is content-identical: the executor LRU hits
    assert runtime.cache_info()["misses"] == misses
    assert _kinds(s2) == ["restored"]
    assert torch.equal(got, want)
    # restored labels seed warm starts exactly like home-grown ones
    _check(s2, _drift(A, seed=31), B)
    assert _kinds(s2)[-2:] == ["warm_replan", "saved"]


def test_corrupt_store_entry_is_quarantined_and_replanned(tmp_path):
    store = str(tmp_path / "store")
    A, B = _mats(32)
    _check(_session(p=4, model="rowwise", store_dir=store), A, B)
    (key,) = list_plans(store)
    blob = os.path.join(store, key, "arrays.npz")
    raw = bytearray(open(blob, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(blob, "wb").write(bytes(raw))

    s2 = _session(p=4, model="rowwise", store_dir=store)
    with pytest.warns(RuntimeWarning, match="quarantin"):
        _check(s2, A, B)
    assert _kinds(s2)[:1] == ["cold_replan"]  # the store gave nothing back
    assert list_plans(store) == [key]  # a fresh plan saved under the key
    assert any(d.startswith(key + ".quarantined") for d in os.listdir(store))
