"""The harness finds a configuration, a mix and a metric by name: adding
them takes new files and entries, and no edit of a file already there."""
import json
import shutil
import time

import torch

from spgemm_bench.harness import run_cell
from spgemm_bench.spec import Spec
from spgemm_bench.tests.conftest import ROOT


def test_new_config_mix_and_metric_need_only_new_files(tmp_path):
    shutil.copytree(ROOT / "spgemm_bench", tmp_path / "spgemm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "spgemm_bench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    cfg = json.loads((ROOT / "spgemm_bench/configs/lp-pds100.json").read_text())
    cfg.update(name="lp-pds80", rows=129, cols=434, blocks=3)
    (tmp_path / "spgemm_bench/configs/lp-pds80.json").write_text(json.dumps(cfg))
    (tmp_path / "spgemm_bench/traffic/pairs.json").write_text(json.dumps(
        {"driver": "serve", "clients": 2, "max_batch": 2, "batch_window": 4,
         "queue_limit": 8, "pool": 4, "sample": 2, "warmup": 1, "trace": 2}))
    (tmp_path / "spgemm_bench/metrics/requests_answered.py").write_text(
        "def read(run):\n    return run.tally.requests\n")
    bench["configs"].append({"name": "lp-pds80", "source": "https://arxiv.org/abs/1603.05627",
                             "file": "spgemm_bench/configs/lp-pds80.json",
                             "reduced": ["rows", "cols"], "why": "a second LP size"})
    bench["workloads"].append({"name": "lp-pds80.pairs", "config": "lp-pds80",
                               "traffic": "pairs", "chips": 1, "why": "two clients"})
    bench["per_layer"].append({"name": "requests_answered", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "serving loop",
                               "moves": "products_per_s", "workloads": ["lp-pds80.pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = Spec(tmp_path)
    r = run_cell("lp-pds80.pairs", 5, 0.2, True, torch.device("cpu"), time.perf_counter(), spec)
    assert r["correct"] is True
    assert r["metrics"]["requests_answered"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
