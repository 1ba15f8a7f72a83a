"""The port's spans (``repro_torch.tracing``) on the CPU, and on a card.

- off (no profiler, no ``recording()``), a served run and a loop of handle
  calls record no per-call span and never open a profiler range;
- under ``torch.profiler`` every span but the queue's is a range of the
  Chrome trace, nested as the layers nest, one range for each record;
- a dispatch's record carries its chunk's request ids, a request's queue
  record runs from its ``submit`` to its window;
- self time is the total less the children's, on a fake clock; each thread
  nests its own spans; the buffer keeps the newest records;
- a torch without the fast profiler range gets ``record_function``'s;
- a product, and a served step of 8, record the spans of their sites;
- on a card (``gpu``): K1's kernel lies in the ``k1.launch`` range that
  launched it (the launch's correlation id).
"""
import json
import threading

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import tracing
from repro_torch.distributed import runtime
from repro_torch.kernels.bsr_spgemm import KERNELS
from repro_torch.launch.serve import SpGEMMServer, _mixed_workload, serve_spgemm
from repro_torch.sparse.structure import random_structure, structure_fingerprint

SETUP_SPANS = {"plan.build", "plan.partition", "plan.lower", "runtime.build"}
# each product's spans: the front door, the runtime, the executor, K1
PER_PRODUCT = {"api.prepare": 1, "runtime.copy_in": 1, "runtime.run": 1, "exec.expand": 2,
               "k1.launch": 1, "runtime.unpack": 1}
# (child, parent): every range of the child lies in one of the parent's
NESTS = [
    ("exec.expand", "runtime.run"),
    ("k1.launch", "runtime.run"),
    ("runtime.copy_in", "api.prepare"),
    ("api.prepare", "session.call"),
    ("runtime.run", "session.call"),
    ("runtime.unpack", "session.call"),
    ("session.call", "serve.dispatch"),
    ("serve.sync", "serve.dispatch"),
    ("serve.dispatch", "serve.step"),
    ("plan.partition", "serve.step"),
    ("runtime.build", "serve.step"),
]


def _serve(max_batch=8):
    """The serving CLI's smoke traffic (pool hits, a drifted structure, a
    cold one) through monoC on the CPU."""
    runtime.cache_clear()
    workload = _mixed_workload(48, 0.06, 2, 24, 0.1, 0)
    return serve_spgemm(workload, p=4, model="monoC", max_batch=max_batch, batch_window=16,
                        device="cpu")


def _handle(device="cpu"):
    rng = np.random.default_rng(1)
    a_s, b_s = random_structure(40, 32, 0.15, rng), random_structure(32, 36, 0.15, rng)
    h = repro_torch.plan(a_s, b_s, p=4, model="monoC").compile(device=device)
    a = torch.as_tensor(rng.standard_normal(a_s.nnz).astype(np.float32), device=device)
    b = torch.as_tensor(rng.standard_normal(b_s.nnz).astype(np.float32), device=device)
    return h, a, b


def _trace_events(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def _ranges(events) -> dict:
    """The host ranges named after a span (``cpu_op`` events)."""
    out = {}
    for e in events:
        if e.get("cat") == "cpu_op" and e["name"] in tracing.SPANS:
            out.setdefault(e["name"], []).append(e)
    return out


def _inside(child, parent, eps=0.01) -> bool:
    return (child["tid"] == parent["tid"] and child["ts"] >= parent["ts"] - eps
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + eps)


def test_off_no_per_call_span_records_and_no_range_opens(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range opened with the tracer off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tracing.reset()
    requests, report = _serve()
    assert report["completed"] == len(requests) == 24
    snap = tracing.snapshot()
    assert set(snap["spans"]) <= SETUP_SPANS  # planning records always
    assert "plan.partition" in snap["spans"]
    h, a, b = _handle()
    tracing.reset()
    for _ in range(4):
        h(a, b)
    snap = tracing.snapshot()
    assert snap["spans"] == {} and snap["records"] == []


def test_on_every_span_is_a_range_nested_as_the_layers(tmp_path):
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        requests, _ = _serve()
    snap = tracing.snapshot()
    ranges = _ranges(_trace_events(prof, tmp_path))
    # the queue's span opens before the step that ends it: a record alone
    assert set(ranges) == set(tracing.SPANS) - {"serve.queue"}
    for name, rs in ranges.items():
        assert len(rs) == snap["spans"][name].calls, name  # the k-th record, the k-th range
    for child, parent in NESTS:
        for c in ranges[child]:
            assert any(_inside(c, p) for p in ranges[parent]), (child, parent)
    queue = [r for r in snap["records"] if r.name == "serve.queue"]
    assert sorted(r.rids for r in queue) == [(q.rid,) for q in requests]
    for rec in queue:
        q = requests[rec.rids[0]]
        assert rec.parent is None
        assert rec.start_ns == round(q.t_submit * 1e9) and rec.end_ns == round(q.t_start * 1e9)
        assert q.t_submit <= q.t_start <= q.t_done


def test_dispatch_records_carry_their_chunks_request_ids():
    tracing.reset()
    with tracing.recording():
        requests, report = _serve(max_batch=3)
    records = tracing.snapshot()["records"]
    by_id = {r.id: r for r in records}
    dispatches = [r for r in records if r.name == "serve.dispatch"]
    assert len(dispatches) == report["dispatches"]
    rids = [rid for d in dispatches for rid in d.rids]
    assert sorted(rids) == [q.rid for q in requests]
    for d in dispatches:
        chunk = [requests[rid] for rid in d.rids]
        assert 1 <= len(chunk) <= 3
        # one dispatch: one structure, one moment done
        keys = {(structure_fingerprint(q.a_s), structure_fingerprint(q.b_s)) for q in chunk}
        assert len(keys) == 1
        assert len({q.t_done for q in chunk}) == 1
        assert by_id[d.parent].name == "serve.step"
    calls = [r for r in records if r.name == "session.call"]
    assert [by_id[c.parent].name for c in calls] == ["serve.dispatch"] * len(dispatches)


def test_self_time_is_the_total_less_the_childrens():
    ticks = iter([0, 1, 2, 5, 7, 8, 10, 20])
    t = tracing.Tracer(clock=lambda: next(ticks))
    with t.recording():
        with t.span("a") as a:
            with t.span("b") as b:
                with t.span("c"):
                    pass
            t.interval("q", 1e-9, 4e-9, (7,))  # after the fact: nobody's child
            with t.span("d"):
                pass
    snap = t.snapshot()
    assert snap["spans"] == {
        "a": tracing.Aggregate(1, 20, 20 - 6 - 2),
        "b": tracing.Aggregate(1, 6, 6 - 3),
        "c": tracing.Aggregate(1, 3, 3),
        "d": tracing.Aggregate(1, 2, 2),
        "q": tracing.Aggregate(1, 3, 3),
    }
    parents = {r.name: r.parent for r in snap["records"]}
    assert parents == {"a": None, "b": a.id, "c": b.id, "d": a.id, "q": None}
    assert [r.name for r in snap["records"]] == ["c", "b", "q", "d", "a"]  # as they closed
    t.reset()
    assert t.snapshot() == {"spans": {}, "records": [], "dropped": 0}


def test_each_thread_nests_its_own_spans():
    t = tracing.Tracer()
    both = threading.Barrier(2)

    def work(tag):
        for _ in range(20):
            with t.span(f"{tag}.outer"):
                both.wait()  # the other thread's spans open and close meanwhile
                with t.span(f"{tag}.inner"):
                    both.wait()
                both.wait()

    with t.recording():
        threads = [threading.Thread(target=work, args=(tag,)) for tag in "ab"]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    snap = t.snapshot()
    by_id = {r.id: r for r in snap["records"]}
    assert len(by_id) == len(snap["records"]) == 80
    for r in snap["records"]:
        tag, part = r.name.split(".")
        if part == "inner":
            assert by_id[r.parent].name == f"{tag}.outer"
        else:
            assert r.parent is None
    for name, agg in snap["spans"].items():
        assert agg.calls == 20 and 0 <= agg.self_ns <= agg.total_ns, name


def test_without_the_fast_range_a_span_opens_record_functions(monkeypatch, tmp_path):
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast", raising=False)
    h, a, b = _handle()
    h(a, b)
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            h(a, b)
    names = [e["name"] for e in _trace_events(prof, tmp_path)
             if e.get("cat") == "user_annotation" and e["name"] in tracing.SPANS]
    assert {n: names.count(n) for n in set(names)} == {k: 2 * n for k, n in PER_PRODUCT.items()}


def test_the_buffer_keeps_the_newest_records():
    t = tracing.Tracer(records=4)
    assert t.span("x") is t.span("y")  # off: one shared object
    with t.recording():
        for i in range(10):
            with t.span("x", rids=[i]):
                pass
    snap = t.snapshot()
    assert snap["spans"]["x"].calls == 10 and snap["dropped"] == 6
    assert [r.rids for r in snap["records"]] == [(6,), (7,), (8,), (9,)]


def test_a_product_and_a_served_step_record_their_sites():
    h, a, b = _handle()
    h(a, b)
    tracing.reset()
    with tracing.recording():
        for _ in range(5):
            h(a, b)
    calls = {k: v.calls for k, v in tracing.snapshot()["spans"].items()}
    assert calls == {k: 5 * n for k, n in PER_PRODUCT.items()}

    server = SpGEMMServer(p=4, model="monoC", max_batch=8, device="cpu")
    s = h.planned.instance
    values = [(a.numpy(), b.numpy())] * 8
    for _ in range(2):  # the first step plans and compiles
        reqs = [server.submit((s.a, av), (s.b, bv)) for av, bv in values]
        tracing.reset()
        with tracing.recording():
            assert server.step() == 8
    assert all(r.result is not None for r in reqs)
    calls = {k: v.calls for k, v in tracing.snapshot()["spans"].items()}
    assert calls == {"serve.step": 1, "serve.queue": 8, "serve.dispatch": 1, "session.call": 1, "serve.sync": 1, **PER_PRODUCT}


@pytest.mark.gpu
def test_k1_kernel_lies_in_the_k1_launch_range(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, a, b = _handle(torch.device("cuda"))
    h(a, b)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            h(a, b)
        torch.cuda.synchronize()
    events = _trace_events(prof, tmp_path)
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    k1 = [e for e in events if e.get("cat") == "kernel" and any(k in e["name"] for k in KERNELS)]
    assert len(k1) == 3
    ranges = _ranges(events)["k1.launch"]
    for kernel in k1:
        launch = launches[kernel["args"]["correlation"]]
        assert any(_inside(launch, r) for r in ranges), kernel["name"]
