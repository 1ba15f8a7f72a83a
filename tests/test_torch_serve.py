"""The port's serving tier on the CPU: batched executors and the serving loop
(``repro_torch.launch.serve``), held to the JAX package's on the same seeded
values.

- ``batch_bucket`` equals the reference's;
- ``compile(batch=m)`` equals m single calls for every executable model at
  p in {1, 4} (monoC bit for bit: its one K1 launch sums every C slot in
  the same order), and the JAX package's batched handle at p = 1;
- ragged batches inside one bucket reuse one executor (the LRU's misses,
  the port's counterpart of ``trace_count()``, do not move);
- the serving loop's lifecycle, counts and report keys equal JAX's at
  p = 1; admission control, retries and failure isolation; the CLI.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.distributed.runtime import batch_bucket as jax_batch_bucket
from repro.launch.serve import SpGEMMServer as JaxServer
from repro.resilience import FaultPolicy as JaxFaultPolicy
from repro.sparse.structure import from_dense as jax_from_dense
from repro_torch.distributed import runtime
from repro_torch.distributed.comm import Loopback
from repro_torch.distributed.plan_ir import moved_items
from repro_torch.distributed.spgemm_exec import MonoCStep
from repro_torch.launch.serve import QueueFull, SpGEMMServer, serve_spgemm
from repro_torch.resilience import FaultPolicy
from repro_torch.sparse.structure import from_dense
from repro_torch.testing import faults
from repro_torch.testing.faults import InjectedFault

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)  # against the dense float32 product
TOL_JAX = dict(rtol=1e-5, atol=1e-5)  # port vs reference: summation order only
M = 4


def _masks(seed=3, shape=(16, 13, 15), density=0.25):
    rng = np.random.default_rng(seed)
    I, K, J = shape
    a = rng.random((I, K)) < density
    b = rng.random((K, J)) < density
    a[np.arange(I), rng.integers(0, K, I)] = True  # no empty rows
    b[np.arange(K), rng.integers(0, J, K)] = True
    return a, b


@pytest.fixture(scope="module")
def operands():
    a, b = _masks()
    a_s, b_s = from_dense(a), from_dense(b)
    rng = np.random.default_rng(4)
    av = rng.standard_normal((M, a_s.nnz)).astype(np.float32)
    bv = rng.standard_normal((M, b_s.nnz)).astype(np.float32)
    return a, b, a_s, b_s, av, bv


def _dense(s, vals):
    d = np.zeros(s.shape, np.float32)
    d[s.coo()] = vals
    return d


def test_batch_bucket_equals_jax():
    assert [runtime.batch_bucket(n) for n in range(1, 101)] == [
        jax_batch_bucket(n) for n in range(1, 101)
    ]
    with pytest.raises(ValueError, match="batch size"):
        runtime.batch_bucket(0)


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("model", repro_torch.executable_models())
def test_batched_equals_looped(operands, model, p):
    _, _, a_s, b_s, av, bv = operands
    handle = repro_torch.plan(a_s, b_s, p=p, model=model)
    one = handle.compile(device="cpu")
    exe = handle.compile(device="cpu", batch=M)
    assert exe.batch_capacity == M
    got = exe(av, bv)
    assert got.shape == (M, 16, 15) and got.device.type == "cpu"
    for i in range(M):
        want = one(av[i], bv[i])
        if model == "monoC":
            assert torch.equal(got[i], want), i
        else:
            np.testing.assert_allclose(got[i].numpy(), want.numpy(), **TOL_JAX)
        np.testing.assert_allclose(
            got[i].numpy(), _dense(a_s, av[i]) @ _dense(b_s, bv[i]), **TOL
        )
    # the collective moves the plan's items for every slot of the capacity
    comm = exe.runtime.comm
    comm.reset()
    exe(av[:3], bv[:3])
    assert comm.items_moved == M * moved_items(handle.execution_plan)


@pytest.mark.parametrize("model", repro_torch.executable_models())
def test_batched_equals_jax_at_p1(operands, model):
    a, b, a_s, b_s, av, bv = operands
    want = np.asarray(
        repro.plan(jax_from_dense(a), jax_from_dense(b), p=1, model=model).compile(
            batch=M
        )(av, bv)
    )
    got = repro_torch.plan(a_s, b_s, p=1, model=model).compile(device="cpu", batch=M)(av, bv)
    np.testing.assert_allclose(got.numpy(), want, **TOL_JAX)


def test_ragged_batches_share_one_executor(operands):
    _, _, a_s, b_s, av, bv = operands
    handle = repro_torch.plan(a_s, b_s, p=4, model="fine")
    exe = handle.compile(device="cpu", batch=M)
    exe(av[:2], bv[:2])
    misses = runtime.cache_info()["misses"]
    for m in (1, 2, 3, 4):
        assert exe(av[:m], bv[:m]).shape[0] == m
    for m in (3, 4):  # the same bucket: the same executor, nothing rebuilt
        assert handle.compile(device="cpu", batch=m).runtime is exe.runtime
    assert runtime.cache_info()["misses"] == misses
    assert handle.compile(device="cpu", batch=2).runtime is not exe.runtime


@pytest.mark.parametrize("model", repro_torch.executable_models())
def test_ragged_batch_equals_the_full_batch_it_pads_to(operands, model):
    """A ragged batch is zero-padded to the capacity and trimmed back: its
    sets are the full batch's first ones, bit for bit (one executor, the
    same packed tables in the sets it keeps)."""
    _, _, a_s, b_s, av, bv = operands
    exe = repro_torch.plan(a_s, b_s, p=4, model=model).compile(device="cpu", batch=M)
    full = exe(av, bv)
    for m in (1, 3):
        got = exe(av[:m], bv[:m])
        assert got.shape == (m, 16, 15)
        assert torch.equal(got, full[:m]), m


def test_runtime_refuses_an_empty_batch(operands):
    _, _, a_s, b_s, _, _ = operands
    plan = repro_torch.plan(a_s, b_s, p=4, model="fine").execution_plan
    with pytest.raises(ValueError, match="batch must be >= 1"):
        runtime.compile_spgemm(plan, a_s, b_s, device="cpu", batch=0)


def test_batched_inputs_are_not_written(operands):
    _, _, a_s, b_s, av, bv = operands
    exe = repro_torch.plan(a_s, b_s, p=4, model="monoC").compile(device="cpu", batch=M)
    av_copy, bv_copy = av.copy(), bv.copy()
    r1, r2 = exe(av, bv), exe(av, bv)
    assert torch.equal(r1, r2)
    np.testing.assert_array_equal(av, av_copy)
    np.testing.assert_array_equal(bv, bv_copy)


def test_batch_overflow_and_operand_mismatch_raise(operands):
    _, _, a_s, b_s, av, bv = operands
    exe = repro_torch.plan(a_s, b_s, p=1, model="rowwise").compile(device="cpu", batch=2)
    with pytest.raises(ValueError, match="batch"):
        exe(av, bv)  # 4 rows into a capacity-2 executor
    with pytest.raises(ValueError, match="batch"):
        exe(av[:2], bv[:1])  # mismatched A/B batch sizes


# ---------------------------------------------------------------------------
# the serving loop at p = 1, against the JAX package's
# ---------------------------------------------------------------------------
def _stream(rng, count, masks):
    """(A, B) operand pairs as dense float32 arrays on the given masks."""
    out = []
    for _ in range(count):
        a, b = masks
        out.append(
            (
                (a * rng.standard_normal(a.shape)).astype(np.float32),
                (b * rng.standard_normal(b.shape)).astype(np.float32),
            )
        )
    return out


def _lifecycle(server, rng_seed):
    """enqueue -> batch -> evict -> drain on three structures; returns the
    operand pairs in submission order."""
    rng = np.random.default_rng(rng_seed)
    structs = [_masks(seed, (14, 14, 14)) for seed in (5, 6, 7)]
    pairs = _stream(rng, 6, structs[0])
    requests = [server.submit(a, b) for a, b in pairs]
    server.step()
    for s in (structs[1], structs[2]):
        for a, b in _stream(rng, 1, s):
            pairs.append((a, b))
            requests.append(server.submit(a, b))
    server.drain()
    for s in (structs[2], structs[0]):
        for a, b in _stream(rng, 1, s):
            pairs.append((a, b))
            requests.append(server.submit(a, b))
    server.drain()
    return pairs, requests


def test_serving_loop_lifecycle_equals_jax():
    kw = dict(p=1, model="rowwise", max_batch=4, batch_window=8, pool_entries=2)
    server = SpGEMMServer(device="cpu", **kw)
    jax_server = JaxServer(**kw)
    pairs, requests = _lifecycle(server, 11)
    _, jax_requests = _lifecycle(jax_server, 11)
    for (a, b), req, jreq in zip(pairs, requests, jax_requests):
        assert req.done and req.latency_s >= 0
        assert req.result.device.type == "cpu"
        np.testing.assert_allclose(req.result.numpy(), a @ b, **TOL)
        np.testing.assert_allclose(req.result.numpy(), jreq.result, **TOL_JAX)
    events = [(e.kind, e.model) for e in server.session.events]
    assert events == [(e.kind, e.model) for e in jax_server.session.events]
    assert "evict" in [k for k, _ in events]
    for field in ("submitted", "completed", "failed", "rejected", "dispatches",
                  "batch_items", "batch_slots"):
        assert getattr(server.stats, field) == getattr(jax_server.stats, field), field
    report, jax_report = server.report(), jax_server.report()
    assert report.keys() == jax_report.keys()
    assert report["pool"] == jax_report["pool"]
    assert report["completed"] == 10 and report["failed"] == 0
    assert report["qps"] > 0 and report["p99_us"] >= report["p50_us"] > 0
    assert 0 < report["batch_efficiency"] <= 1


def test_admission_rejects_when_full():
    rng = np.random.default_rng(6)
    server = SpGEMMServer(p=1, model="rowwise", queue_limit=2, device="cpu")
    for a, b in _stream(rng, 2, _masks(6, (12, 12, 12))):
        server.submit(a, b)
    with pytest.raises(QueueFull, match="capacity"):
        server.submit(*_stream(rng, 1, _masks(6, (12, 12, 12)))[0])
    assert server.stats.rejected == 1
    server.drain()  # the admitted two still complete
    assert server.stats.completed == 2


def test_serve_spgemm_steps_inline_on_full_queue():
    rng = np.random.default_rng(7)
    workload = _stream(rng, 9, _masks(7, (12, 12, 12)))
    requests, report = serve_spgemm(
        workload, p=4, model="monoC", queue_limit=4, max_batch=4, batch_window=4,
        device="cpu",
    )
    assert report["completed"] == 9 and report["failed"] == 0
    for (a, b), req in zip(workload, requests):
        np.testing.assert_allclose(req.result.numpy(), a @ b, **TOL)


def test_serving_loop_retries_scripted_transient_fault():
    rng = np.random.default_rng(8)
    server = SpGEMMServer(
        p=4, model="monoC", max_batch=4, policy=FaultPolicy(backoff_s=0.0), device="cpu"
    )
    pairs = _stream(rng, 4, _masks(8, (12, 12, 12)))
    requests = [server.submit(a, b) for a, b in pairs]
    with faults.inject("execute", times=1) as script:
        server.drain()
    assert script.fired == 1
    assert server.stats.completed == 4 and server.stats.failed == 0
    assert [e.detail["stage"] for e in server.session.events if e.kind == "retry"] == ["execute"]
    for (a, b), req in zip(pairs, requests):
        np.testing.assert_allclose(req.result.numpy(), a @ b, **TOL)


def test_serving_loop_isolates_permanent_failure():
    """A batch that exhausts the retry budget marks only its own requests
    failed; the loop keeps serving the next window (as the reference's)."""
    rng = np.random.default_rng(9)
    masks = _masks(9, (12, 12, 12))
    runs = {}
    for name, cls, policy, kw in (
        ("port", SpGEMMServer, FaultPolicy(max_retries=1, backoff_s=0.0), {"device": "cpu"}),
        ("jax", JaxServer, JaxFaultPolicy(max_retries=1, backoff_s=0.0), {}),
    ):
        server = cls(p=1, model="rowwise", max_batch=4, policy=policy, **kw)
        doomed = [server.submit(a, b) for a, b in _stream(rng, 2, masks)]
        if name == "port":
            with faults.inject("execute", times=2) as script:
                server.drain()
            assert script.fired == 2
            assert all(isinstance(r.error, InjectedFault) and r.done for r in doomed)
        else:
            from repro.testing import faults as jax_faults

            with jax_faults.inject("execute", times=2):
                server.drain()
        assert server.stats.failed == 2 and server.stats.completed == 0
        healthy = [server.submit(a, b) for a, b in _stream(rng, 2, masks)]
        server.drain()
        assert server.stats.completed == 2
        assert all(r.result is not None for r in healthy)
        runs[name] = [(e.kind, e.model, e.detail.get("stage")) for e in server.session.events]
    assert runs["port"] == runs["jax"]


def test_cli_smoke_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--p", "4", "--smoke",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "oracle spot-check: OK" in out.stdout
    assert "completed: 24" in out.stdout and "failed: 0" in out.stdout
    assert "device: cpu" in out.stdout


def test_loopback_takes_a_batch_axis():
    comm = Loopback(3, batch=2)
    buf = torch.arange(2 * 3 * 3 * 4, dtype=torch.float32).reshape(2, 3, 3, 4)
    out = comm.all_to_all(buf, n_items=5)
    assert torch.equal(out, buf.transpose(1, 2))
    assert comm.items_moved == 2 * 5  # every set of the capacity
    comm.reset()
    out = comm.psum_scatter(buf.reshape(2, 3, 3, 2, 2))
    assert torch.equal(out, buf.reshape(2, 3, 3, 2, 2).sum(1))
    assert comm.items_moved == 2 * 3 * 2 * 2 * 2  # (p - 1) / p of each set
    with pytest.raises(ValueError, match=r"\(2, 3, 3, T"):
        comm.all_to_all(buf[0], n_items=5)


def test_batched_monoC_guards_its_int32_indices(operands):
    _, _, a_s, b_s, _, _ = operands
    plan = repro_torch.plan(a_s, b_s, p=4, model="monoC").execution_plan
    slots = 4 * max(plan.a_table_slots, plan.b_table_slots, plan.n_c_slots)
    with pytest.raises(ValueError, match="int32"):
        MonoCStep(plan, 1, "cpu", batch=2**31 // slots + 1)
