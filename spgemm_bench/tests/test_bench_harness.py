"""Every cell end to end on the CPU at a tiny size, and the faults a cell
can have planted under the timed path: each has to come out not correct."""
import json
import subprocess
import sys
import time

import pytest
import torch

from spgemm_bench.harness import run_cell
from spgemm_bench.spec import Spec
from spgemm_bench.tests.conftest import ROOT, tiny

SPEC = Spec()
WORKLOADS = [w["name"] for w in SPEC.data["workloads"]]
SEED = 2**31 + 11  # past 32 signed bits, as the runs' seeds are


def _run(workload, traced=False, seconds=0.3):
    return run_cell(workload, SEED, seconds, traced, torch.device("cpu"), time.perf_counter(),
                    SPEC, tiny(SPEC, workload))


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_end_to_end_on_the_cpu(workload, traced):
    r = _run(workload, traced)
    assert r["correct"] is True
    assert r["failed"] == 0 and r["attempted"] > 0 and r["compared"] > 0
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    named = {m["name"] for m in SPEC.metrics(workload, per_layer=traced)}
    assert set(r["metrics"]) <= named
    if traced:
        # the CPU has no device trace: the device's metrics say nothing
        assert {"plan_s", "pack_ms", "moved_words"} <= set(r["metrics"])
        assert not {"k1_roofline", "exec_device_ms", "device_idle_pct"} & set(r["metrics"])
        assert "breakdown" in r and "busy_s" in r["device"]
    else:
        assert {"products_per_s", "setup_s"} <= set(r["metrics"])
    json.dumps(r)


def _exchange_left_out(monkeypatch):
    from repro_torch.distributed import comm

    monkeypatch.setattr(comm.Loopback, "all_to_all", lambda self, buf, n_items: buf)


def _answer_altered(monkeypatch):
    from repro_torch.distributed import spgemm_exec

    local = spgemm_exec.bsr_spgemm_local

    def altered(*args, **kwargs):
        c = local(*args, **kwargs)
        c.view(-1)[0] += 1.0
        return c

    monkeypatch.setattr(spgemm_exec, "bsr_spgemm_local", altered)


def _half_batch_left_out(monkeypatch):
    from repro_torch.distributed import runtime

    run = runtime.CompiledSpGEMM.run

    def half(self, tables):
        c = run(self, tables)
        if self.batch:
            c[self.batch // 2:] = 0
        return c

    monkeypatch.setattr(runtime.CompiledSpGEMM, "run", half)


def _stale_answer(monkeypatch):
    from repro_torch import api

    run, first = api.CompiledSpGEMM.run, {}

    def stale(self, prepared):
        # the first answer of each shape, from the warm-up on: a window of
        # one dispatch still gets a stale one
        c = run(self, prepared)
        return first.setdefault(tuple(c.shape), c)

    monkeypatch.setattr(api.CompiledSpGEMM, "run", stale)


FAULTS = {"exchange_left_out": _exchange_left_out, "answer_altered": _answer_altered,
          "stale_answer": _stale_answer, "half_batch_left_out": _half_batch_left_out}


def _serves(workload):
    return SPEC.traffic(SPEC.workload(workload)["traffic"])["driver"] == "serve"


# every fault a cell can have: only the serving cells batch
CASES = [(w, f) for w in WORKLOADS for f in sorted(FAULTS)
         if f != "half_batch_left_out" or _serves(w)]


@pytest.mark.parametrize(("workload", "fault"), CASES)
def test_a_planted_fault_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = _run(workload)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_run_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "spgemm_bench" / "run.py"), "--workload", WORKLOADS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_the_client_sweep_reads_every_count_on_the_cpu():
    from spgemm_bench import sweep
    from spgemm_bench.harness import Cell

    serving = next(w for w in WORKLOADS if _serves(w))
    cell = Cell(serving, torch.device("cpu"), SPEC, tiny(SPEC, serving))
    rows = sweep.sweep(cell, SEED, 0.2, [1, 3, 8])
    assert [r["clients"] for r in rows] == [1, 3, 8]
    assert all(r["requests"] > 0 and r["failed"] == 0 and r["products_per_s"] > 0 for r in rows)
    assert rows[1]["batch_fill_pct"] < 100.0  # 3 clients leave slots of a batch of 8 empty
