"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the ``file`` of its entry (``configs/<name>.json``), whose
  ``generator`` names ``generators/<generator>.py``;
- a traffic mix: ``traffic/<traffic>.json``;
- a per-layer metric: ``metrics/<name>.py``, whose ``read(run)`` returns the
  metric's value or None where the run holds nothing to read.

A new configuration, mix or metric is a new file and a new entry; no file
here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def add_program_path(root: Path = ROOT) -> None:
    """Put the checkout's ``src`` (the port's package) on ``sys.path``."""
    src = str(Path(root) / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def load_module(path: Path, kind: str):
    name = "spgemm_bench_" + kind + "_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / self.data["paths"][0]

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def generator(self, name: str):
        return load_module(self.bench / "generators" / f"{name}.py", "generator")

    def reader(self, metric: str):
        return load_module(self.bench / "metrics" / f"{metric}.py", "metric")

    def metrics(self, workload: str, per_layer: bool) -> list:
        """The metrics a run of ``workload`` reports: its end-to-end ones
        (``--trace 0``) or its per-layer ones (``--trace 1``)."""
        group = self.data["per_layer" if per_layer else "end_to_end"]
        return [m for m in group if workload in m.get("workloads", [workload])]
