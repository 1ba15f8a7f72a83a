"""Closed-loop client sweep of a serving cell: the rate and the tail at each
number of clients, from one set-up.

    python3 spgemm_bench/sweep.py --workload lp-pds100.serve8 --seed 5 \\
        --seconds 5 --clients 1,2,4,8,16,32

Prints one JSON line a client count: products/s, the median and 95th
percentile latency in ms, and the share of batch slots filled.  The knee of
the sweep, where the rate stops rising and the tail starts to, sets a
serving mix's ``clients``.  The benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from spgemm_bench import drive  # noqa: E402
from spgemm_bench.spec import add_program_path  # noqa: E402


def sweep(cell, seed: int, seconds: float, clients: list) -> list:
    pool, order = cell.values(seed)
    cell.warm_up(pool, order, seed)
    sync, driver, rows = drive.synchronizer(cell.device), cell.driver, []
    for n in clients:
        driver.clients = n
        driver.run(pool, order, drive.Tally(), count=cell.traffic["warmup"])
        items0, slots0 = driver.batch_stats()
        tally = drive.Tally()
        sync()
        start = time.perf_counter()
        driver.run(pool, order, tally, deadline=start + seconds)
        sync()
        window_s = time.perf_counter() - start
        items, slots = driver.batch_stats()
        lat = np.asarray(tally.latencies) * 1e3
        rows.append({"clients": n, "products_per_s": tally.products / window_s,
                     "p50_ms": float(np.percentile(lat, 50)),
                     "p95_ms": float(np.percentile(lat, 95)),
                     "batch_fill_pct": 100.0 * (items - items0) / max(slots - slots0, 1),
                     "requests": tally.requests, "failed": tally.failed})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--clients", default="1,2,4,8,16,32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    add_program_path()
    from spgemm_bench.harness import Cell

    cell = Cell(args.workload, torch.device(args.device))
    if cell.traffic["driver"] != "serve":
        print(f"{args.workload} is not a serving cell", file=sys.stderr)
        return 2
    sweep(cell, args.seed, args.seconds, [int(x) for x in args.clients.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
