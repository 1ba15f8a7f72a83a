"""The metrics that read the program's own spans (``program_spans.py``):
a traced tiny CPU run reports each in its cells, above 0; a reader gives
None, and does not raise, where its span is absent or the program has no
tracer (the parent of the change that brought it)."""
import sys
import time
import types

import pytest
import torch

from spgemm_bench import drive
from spgemm_bench.harness import run_cell
from spgemm_bench.spec import Spec
from spgemm_bench.tests.conftest import tiny

SPEC = Spec()
WORKLOADS = [w["name"] for w in SPEC.data["workloads"]]
SPAN_METRICS = ["serve_queue_ms", "h2d_ms", "expand_host_ms", "k1_host_ms", "partition_s"]
SEED = 2**31 + 23


def test_each_span_metric_is_declared_as_the_programs():
    declared = {m["name"]: m for m in SPEC.data["per_layer"]}
    for name in SPAN_METRICS:
        assert declared[name]["source"] == "program_span"
        assert set(declared[name]["workloads"]) <= set(WORKLOADS)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_traced_run_reports_each_span_metric_of_its_cell(workload):
    from repro_torch import tracing

    tracing.reset()
    r = run_cell(workload, SEED, 0.3, True, torch.device("cpu"), time.perf_counter(), SPEC,
                 tiny(SPEC, workload))
    assert r["correct"] is True
    mine = {m["name"] for m in SPEC.metrics(workload, per_layer=True)} & set(SPAN_METRICS)
    assert mine, workload
    for name in SPAN_METRICS:
        if name in mine:
            assert r["metrics"][name]["value"] > 0, name
            assert r["metrics"][name]["unit"] in ("ms", "s")
        else:
            assert name not in r["metrics"]


def _run(products=8, requests=8):
    return types.SimpleNamespace(segment_tally=drive.Tally(requests=requests, products=products))


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_reader_gives_none_where_its_span_is_absent(name, monkeypatch):
    from repro_torch import tracing

    reader = SPEC.reader(name)
    monkeypatch.setattr(tracing, "snapshot", lambda: {"spans": {}, "records": [], "dropped": 0})
    assert reader.read(_run()) is None
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)  # a program without it
    monkeypatch.delattr(sys.modules["repro_torch"], "tracing")
    assert reader.read(_run()) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_reader_divides_by_the_segments_count(name, monkeypatch):
    from repro_torch import tracing

    agg = {k: tracing.Aggregate(4, 8_000_000, 1) for k in tracing.SPANS}
    monkeypatch.setattr(tracing, "snapshot", lambda: {"spans": agg, "records": [], "dropped": 0})
    value = SPEC.reader(name).read(_run(products=16, requests=2))
    expected = {"serve_queue_ms": 2.0, "h2d_ms": 0.5,
                "expand_host_ms": 0.5, "k1_host_ms": 0.5, "partition_s": 0.008}
    assert value == pytest.approx(expected[name])
    if name not in ("partition_s", "serve_queue_ms"):  # an untraced run has no segment
        assert SPEC.reader(name).read(types.SimpleNamespace(segment_tally=None)) is None
