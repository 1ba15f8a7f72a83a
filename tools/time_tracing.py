#!/usr/bin/env python3
"""The cost of the port's spans (``repro_torch.tracing``) on one card's host,
and the host split they give.  One JSON line a reading, then the card's
name and power limit:

- ``site``: ns a span site costs with nothing recording (``timeit`` of
  ``with tracing.span(...): pass`` less ``pass``, and of
  ``tracing.interval``), and inside ``tracing.recording()``;
- ``setup``: each cell of ``BENCHMARK.json`` set up as the benchmark sets
  it up (``spgemm_bench.harness.Cell``, the pool, the warm-up), with its
  set-up spans (``plan.*``, ``runtime.build``) in seconds;
- ``window``: the cell's mix run for ``--seconds`` bare, inside
  ``tracing.recording()``, inside it again and bare, in turns in one
  process: ``products_per_s`` of each, and of a recorded window each
  span's calls, total and self host ms a product.

Run from the repository root on a machine with a CUDA card:

    python3 tools/time_tracing.py --seconds 50 --out build/time_tracing.jsonl

``--readings`` takes a subset of ``site window``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def site_ns(tracing) -> dict:
    n, best = 1_000_000, lambda stmt, **kw: min(timeit.repeat(stmt, number=n, repeat=5, **kw))
    g = {"tracing": tracing}
    base = best("pass")
    off = best("with tracing.span('k1.launch'): pass", globals=g)
    interval = best("tracing.interval('serve.queue', 1.0, 2.0, (3,))", globals=g)
    with tracing.recording():
        on = best("with tracing.span('k1.launch'): pass", globals=g)
    tracing.reset()
    return {"reading": "site", "off_ns": (off - base) / n * 1e9,
            "interval_off_ns": (interval - base) / n * 1e9, "on_ns": (on - base) / n * 1e9}


def per_product(tracing, products: int) -> dict:
    return {k: {"calls": a.calls, "total_ms": a.total_ns / products * 1e-6,
                "self_ms": a.self_ns / products * 1e-6}
            for k, a in tracing.snapshot()["spans"].items()}


def cell_readings(workload, spec, device, seed, seconds, tracing, emit) -> None:
    from spgemm_bench import drive
    from spgemm_bench.harness import Cell

    tracing.reset()
    t = time.perf_counter()
    cell = Cell(workload, device, spec)
    pool, order = cell.values(seed)
    cell.warm_up(pool, order, seed)
    sync = drive.synchronizer(device)
    sync()
    emit({"reading": "setup", "workload": workload, "setup_s": time.perf_counter() - t,
          "plan_s": cell.driver.plan_s,
          "spans_s": {k: a.total_ns * 1e-9 for k, a in tracing.snapshot()["spans"].items()}})
    for mode in ("bare", "recording", "recording", "bare"):
        tracing.reset()
        tally = drive.Tally()
        ctx = tracing.recording() if mode == "recording" else contextlib.nullcontext()
        sync()
        t = time.perf_counter()
        with ctx:
            cell.driver.run(pool, order, tally, deadline=t + seconds)
        sync()
        dt = time.perf_counter() - t
        line = {"reading": "window", "workload": workload, "mode": mode, "seconds": dt,
                "products": tally.products, "products_per_s": tally.products / dt}
        if mode == "recording":
            line["spans"] = per_product(tracing, tally.products)
        emit(line)
    del cell, pool
    gc.collect()
    import torch

    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=2**31 + 101)
    ap.add_argument("--cells", nargs="*", default=None, help="default: every cell")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    ap.add_argument("--readings", nargs="*", default=["site", "window"])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from spgemm_bench.spec import Spec, add_program_path

    add_program_path(ROOT)
    import torch
    from repro_torch import tracing

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    spec = Spec(ROOT)
    cells = args.cells or [w["name"] for w in spec.data["workloads"]]
    if "site" in args.readings:
        for _ in range(3):
            emit(site_ns(tracing))
    for w in cells if "window" in args.readings else ():
        cell_readings(w, spec, device, args.seed, args.seconds, tracing, emit)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    emit({"reading": "card", "card": card, "torch": torch.__version__})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
