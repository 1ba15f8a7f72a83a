"""The serving tier over a process group on the CPU: batched executors on
``comm.GroupComm``, ``SpGEMMSession(group=...)`` and
``SpGEMMServer(group=...)``, one rank a process, held to the reference's
multi-device cases (``tests/multidev_runner.py``: ``case_serve`` and
``case_session``) and to the port's one-process ``Loopback`` results.

Four processes are spawned once for the module (``run_ranks``, with a
timeout well under ``launch.ranks.GROUP_TIMEOUT``, so a rank left waiting
in a collective fails the module fast) and run every case:

- (a) every model and summa2d through ``compile(batch=4, group=...)`` and
  ``compile(batch=3, ...)`` (bucket 4, ragged dispatches of 1-4 sets):
  each set bit for bit the batched ``Loopback`` result and within
  ``tests/test_kernels.py``'s 1e-4 of dense ``A @ B``, the ranks' items
  summing to capacity x ``moved_items``, no new LRU miss inside a bucket,
  the input stacks unwritten;
- (b) ``case_session``'s drift loop (n = 48, rowwise, faults scripted at
  four stage boundaries on every rank, 4 rounds), then a new session on the
  same plan store that restores every entry: products within 2e-4 of
  ``M @ M``, 4 replans with a warm one, no replan and no LRU miss after
  the restart, the same event kinds on every rank and in one process;
- (c) faults on one rank alone: a transient ``execute`` fault on rank 1
  (every rank retries), a permanent one on rank 2 (every rank takes the
  same ``model_downgrade``), a failing ``store_save`` on rank 0, the
  writing rank (a ``store_error`` and nothing else);
- (d) ``case_serve``'s loop: 6 requests at ``max_batch=4`` make 2
  dispatches on rank 0, each result within 1e-4 of its dense product.

``python -m repro_torch.launch.serve --ranks`` runs in a subprocess beside
the one-process CLI.  ``test_batched_group_on_the_card`` (marked ``gpu``)
runs the batched monoC product in 4 processes on one card.
"""
import contextlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.distributed import runtime
from repro_torch.distributed.plan_ir import moved_items
from repro_torch.launch.ranks import GROUP_TIMEOUT, run_ranks
from repro_torch.resilience import FaultPolicy
from repro_torch.sparse.structure import random_structure
from repro_torch.testing import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 4
MODELS = (*repro_torch.MODELS, "summa2d")
TOL = dict(rtol=1e-4, atol=1e-4)  # against dense A @ B (tests/test_kernels.py)
SESSION_TOL = dict(rtol=2e-4, atol=2e-4)  # multidev_runner.case_session
SCHEDULE = {"partition": [1], "compile": [1], "execute": [2], "store_save": [0]}
ROUNDS = 4
RAGGED = (1, 2, 3, 4)
TIMEOUT = 240  # seconds for the whole launch, well under GROUP_TIMEOUT


def _operands():
    """``case_serve``'s instance and four value sets of each operand."""
    rng = np.random.default_rng(9)
    a_s = random_structure(34, 28, 0.15, rng)
    b_s = random_structure(28, 30, 0.18, rng)
    av = rng.standard_normal((4, a_s.nnz)).astype(np.float32)
    bv = rng.standard_normal((4, b_s.nnz)).astype(np.float32)
    return a_s, b_s, av, bv


def _dense(s, v):
    out = np.zeros(s.shape, np.float32)
    out[s.coo()] = v
    return out


def _mcl_matrix():
    """``case_session``'s first matrix."""
    rng = np.random.default_rng(5)
    n = 48
    M = (rng.random((n, n)) * (rng.random((n, n)) < 0.2)).astype(np.float32)
    M[np.arange(n), np.arange(n)] = 1.0
    return M


def _drift(C):
    """``case_session``'s prune and renormalize: the next round's matrix."""
    n = C.shape[0]
    C = C.copy()
    C[C < np.quantile(C[C > 0], 0.3)] = 0.0
    col = C.sum(axis=0)
    M = (C / np.where(col > 0, col, 1.0)).astype(np.float32)
    M[np.arange(n), np.arange(n)] += 0.5
    return M


def _session(store, group, model="rowwise"):
    return repro_torch.session(p=P, model=model, policy=FaultPolicy(backoff_s=0.0),
                               store_dir=None if store is None else str(store),
                               device="cpu", group=group)


def _kinds(session):
    return [e.kind for e in session.events]


def _mcl_loop(store, group):
    """``case_session`` on this process: the drift loop under the fault
    schedule, then a new session on the same store replaying the history."""
    s = _session(store, group)
    M, hist, products = _mcl_matrix(), [], []
    with faults.scripted(SCHEDULE) as scripts:
        for _ in range(ROUNDS):
            C = s.multiply(M, M).numpy()
            products.append(C)
            hist.append(M)
            M = _drift(C)
    fired = {stage: script.fired for stage, script in scripts.items()}
    kinds = _kinds(s)
    del s
    s2 = _session(store, group)
    misses = runtime.cache_info()["misses"]
    restored = [s2.multiply(m, m).numpy() for m in hist]
    return {"hist": hist, "products": products, "fired": fired, "kinds": kinds,
            "restored": restored, "kinds_after": _kinds(s2),
            "new_misses": runtime.cache_info()["misses"] - misses}


# -- what every rank runs --------------------------------------------------------
def _batched(group, handles):
    a_s, b_s, av, bv = _operands()
    kept = av.copy(), bv.copy()
    out = {}
    for model in MODELS:
        exe = handles[model].compile(device="cpu", batch=4, group=group)
        exe.runtime.comm.reset()
        c = exe(av, bv).numpy()
        items = exe.runtime.comm.items_moved
        exe3 = handles[model].compile(device="cpu", batch=3, group=group)
        misses = runtime.cache_info()["misses"]
        ragged = {m: exe3(av[:m], bv[:m]).numpy() for m in RAGGED}
        out[model] = {
            "c": c, "items": items, "capacity": exe3.batch_capacity,
            "shared": exe3.runtime is exe.runtime,
            "new_misses": runtime.cache_info()["misses"] - misses, "ragged": ragged,
        }
    out["unwritten"] = all(np.array_equal(x, y) for x, y in zip((av, bv), kept))
    return out


def _one_rank_faults(group, store):
    """(c): each fault armed on one rank alone; the events of every rank."""
    import torch.distributed as dist

    rank = dist.get_rank(group)
    M = _mcl_matrix()

    def on(r, *args, **kw):
        return faults.inject(*args, **kw) if rank == r else contextlib.nullcontext()

    out = {}
    s = _session(None, group)
    s.multiply(M, M)
    with on(1, "execute", times=1):
        out["transient"] = s.multiply(M, M).numpy(), _kinds(s)
    s = _session(None, group, model="fine")
    with on(2, "execute", exc=ValueError, times=1):
        c = s.multiply(M, M).numpy()
    downgrades = [(e.detail["from_model"], e.model) for e in s.events
                  if e.kind == "model_downgrade"]
    out["permanent"] = c, _kinds(s), downgrades
    s = _session(store, group)
    with on(0, "store_save", exc=PermissionError, times=1):
        out["store_save"] = s.multiply(M, M).numpy(), _kinds(s)
    return out


def _serve_loop(group):
    """(d): ``case_serve``'s loop; rank 0's requests and stats."""
    import torch.distributed as dist

    from repro_torch.launch.serve import SpGEMMServer

    server = SpGEMMServer(p=P, model="fine", max_batch=4, batch_window=8, device="cpu",
                          group=group)
    if dist.get_rank(group):
        return {"followed": server.follow()}
    a_s, b_s, _, _ = _operands()
    rng = np.random.default_rng(3)
    reqs = [server.submit((a_s, rng.standard_normal(a_s.nnz).astype(np.float32)),
                          (b_s, rng.standard_normal(b_s.nnz).astype(np.float32)))
            for _ in range(6)]
    server.drain()
    server.close()
    return {"stats": (server.stats.completed, server.stats.dispatches, server.stats.failed),
            "requests": [(r.a_vals, r.b_vals, r.result.numpy()) for r in reqs]}


def _every_case(group, device, handles, workdir):
    out = {"batched": _batched(group, handles)}
    out["session"] = _mcl_loop(os.path.join(workdir, "store"), group)
    out["faults"] = _one_rank_faults(group, os.path.join(workdir, "store_faults"))
    out["serve"] = _serve_loop(group)
    return out


# -- the module's one run of the ranks --------------------------------------------
@pytest.fixture(scope="module")
def handles():
    a_s, b_s, _, _ = _operands()
    return {m: repro_torch.plan(a_s, b_s, p=P, model=m) for m in MODELS}


@pytest.fixture(scope="module")
def ranks(handles, tmp_path_factory):
    assert TIMEOUT < GROUP_TIMEOUT.total_seconds() / 2
    work = tmp_path_factory.mktemp("group_serve")
    results = run_ranks(_every_case, P, device="cpu", workdir=work / "pg",
                        args=(handles, str(work)), timeout=TIMEOUT)
    return [r.result for r in results]


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """(b) in this process, stacked ranks (``Loopback``), on its own store."""
    return _mcl_loop(tmp_path_factory.mktemp("one_process_store"), None)


@pytest.mark.parametrize("model", MODELS)
def test_batched_group_equals_batched_loopback(handles, ranks, model):
    a_s, b_s, av, bv = _operands()
    exe = handles[model].compile(device="cpu", batch=4)
    exe.runtime.comm.reset()
    want = exe(av, bv).numpy()
    assert want.shape == (4, 34, 30)
    for i in range(4):
        np.testing.assert_allclose(want[i], _dense(a_s, av[i]) @ _dense(b_s, bv[i]), **TOL)
    items = []
    for r in ranks:
        got = r["batched"][model]
        assert got["c"].dtype == want.dtype and np.array_equal(got["c"], want), model
        items.append(got["items"])
    assert sum(items) == 4 * moved_items(handles[model].execution_plan)
    assert sum(items) == exe.runtime.comm.items_moved
    assert all(r["batched"]["unwritten"] for r in ranks)


@pytest.mark.parametrize("model", MODELS)
def test_ragged_batches_in_one_bucket_share_one_group_executor(handles, ranks, model):
    _, _, av, bv = _operands()
    exe = handles[model].compile(device="cpu", batch=3)
    for r in ranks:
        got = r["batched"][model]
        assert got["capacity"] == 4 and got["shared"] and got["new_misses"] == 0
        for m in RAGGED:
            assert got["ragged"][m].shape[0] == m
            np.testing.assert_array_equal(got["ragged"][m], exe(av[:m], bv[:m]).numpy())


def test_session_over_the_group_meets_case_session(ranks):
    for r in ranks:
        s = r["session"]
        for M, C in zip(s["hist"], s["products"]):
            np.testing.assert_allclose(C, M @ M, **SESSION_TOL)
        kinds = s["kinds"]
        assert kinds.count("cold_replan") + kinds.count("warm_replan") == ROUNDS, kinds
        assert kinds.count("warm_replan") >= 1, kinds
    # partition and store_save fire on rank 0 alone, the plan's one writer
    assert ranks[0]["session"]["fired"] == {k: len(v) for k, v in SCHEDULE.items()}
    for r in ranks[1:]:
        assert r["session"]["fired"] == {"partition": 0, "compile": 1, "execute": 1,
                                         "store_save": 0}


def test_session_restarts_from_the_store_on_every_rank(ranks):
    for r in ranks:
        s = r["session"]
        for M, C in zip(s["hist"], s["restored"]):
            np.testing.assert_allclose(C, M @ M, **SESSION_TOL)
        assert s["kinds_after"].count("restored") == len(s["hist"]) == ROUNDS
        assert "cold_replan" not in s["kinds_after"] and "warm_replan" not in s["kinds_after"]
        assert s["new_misses"] == 0


def test_session_events_agree_over_ranks_and_with_one_process(ranks, one_process):
    assert one_process["fired"] == {k: len(v) for k, v in SCHEDULE.items()}
    for r in ranks:
        assert r["session"]["kinds"] == one_process["kinds"]
        assert r["session"]["kinds_after"] == one_process["kinds_after"]
        for got, want in zip(r["session"]["products"], one_process["products"]):
            np.testing.assert_array_equal(got, want)  # rowwise: the same products


def test_a_transient_fault_on_one_rank_is_retried_by_every_rank(ranks):
    M = _mcl_matrix()
    for r in ranks:
        c, kinds = r["faults"]["transient"]
        np.testing.assert_allclose(c, M @ M, **SESSION_TOL)
        assert kinds == ["cold_replan", "hit", "retry"], kinds


def test_a_permanent_failure_on_one_rank_downgrades_every_rank(ranks):
    M = _mcl_matrix()
    for r in ranks:
        c, kinds, downgrades = r["faults"]["permanent"]
        np.testing.assert_allclose(c, M @ M, **SESSION_TOL)
        assert kinds == ["cold_replan", "model_downgrade", "cold_replan"], kinds
        assert downgrades == [("fine", "monoC")]


def test_a_failing_store_write_on_the_writing_rank_is_a_store_error(ranks):
    M = _mcl_matrix()
    for r in ranks:
        c, kinds = r["faults"]["store_save"]
        np.testing.assert_allclose(c, M @ M, **SESSION_TOL)
        assert kinds == ["cold_replan", "store_error"], kinds


def test_server_over_the_group_meets_case_serve(ranks):
    a_s, b_s, _, _ = _operands()
    serve = ranks[0]["serve"]
    assert serve["stats"] == (6, 2, 0)  # 6 requests at max_batch 4: 2 dispatches
    for a, b, c in serve["requests"]:
        np.testing.assert_allclose(c, _dense(a_s, a) @ _dense(b_s, b), **TOL)
    assert [r["serve"]["followed"] for r in ranks[1:]] == [6] * (P - 1)


def _cli(*flags):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--p", str(P), "--smoke",
         "--device", "cpu", *flags],
        capture_output=True, text=True, env=env, timeout=TIMEOUT, cwd=ROOT,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_serve_cli_runs_the_ranks_in_processes():
    """``--ranks`` reports what the one-process CLI reports, but for the
    clocks: the same requests, dispatches, batching and pool events."""
    timed = re.compile(r"^  (qps|p50_us|p99_us): ")
    one, ranks = _cli(), _cli("--ranks")
    assert "ranks: 4 processes over gloo" in ranks
    assert "oracle spot-check: OK" in ranks

    def report(text):
        lines = text[text.index("serve report:"):].splitlines()
        return [line for line in lines if not timed.match(line)]

    assert report(ranks) == report(one)
    assert "completed: 24" in ranks


def _card_case(group, device, handle, values):
    exe = handle.compile(device=device, batch=4, group=group)
    exe.runtime.comm.reset()
    c = exe(*(torch.from_numpy(v).to(device) for v in values))
    return c.cpu().numpy(), exe.runtime.comm.items_moved


@pytest.mark.gpu
def test_batched_group_on_the_card(handles, tmp_path):
    """monoC over the group on the card: K1 once a dispatch on every rank,
    each set bit for bit the one-process batched result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, av, bv = _operands()
    card = torch.device("cuda", 0)
    results = run_ranks(_card_case, P, device=card, workdir=tmp_path,
                        args=(handles["monoC"], (av, bv)), timeout=TIMEOUT)
    exe = handles["monoC"].compile(device=card, batch=4)
    want = exe(*(torch.from_numpy(v).to(card) for v in (av, bv))).cpu().numpy()
    for r in results:
        assert r.launches["bsr_spgemm"]["scalar_runs"] == 1
        np.testing.assert_array_equal(r.result[0], want)
    assert sum(r.result[1] for r in results) == 4 * moved_items(handles["monoC"].execution_plan)
