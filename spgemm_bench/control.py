"""Readings that set the comparison's limits: the program's and the control's.

The control is the reference put in the program's place one precision
down: the configurations state fp32 with TF32 off, so the control rounds
every operand to TF32 (10 mantissa bits, to nearest even) and sums in fp32,
as a tensor-core K1 would.  Its outputs are judged exactly as the
program's.  One process sets a cell up once and reads, for each seed, the
program's sample after a short window at the cell's own load, then the
control's on as many requests of other seeds:

    python3 spgemm_bench/control.py --workload amg27-n42.galerkin \\
        --seeds 11-22 --control-seeds 31-33 --seconds 2 --out build/control.json

Each reading is the run's ``checks`` (``judge.py``), printed as one JSON
line per seed and written whole to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from spgemm_bench import drive, judge  # noqa: E402
from spgemm_bench.spec import add_program_path  # noqa: E402


def tf32(x: np.ndarray) -> np.ndarray:
    """fp32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x0FFF + ((u >> 13) & 1)) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32)


def control_outputs(inst, base_values: dict) -> dict:
    """``{product: dense C}`` of the control for one request's values."""
    out, dense = {}, {}
    for prod in inst.products:
        ops = []
        for name in (prod.a, prod.b):
            s = inst.structures[name]
            if name in dense:
                rows = np.repeat(np.arange(s.shape[0]), np.diff(s.indptr))
                vals = dense[name][rows, s.indices]
            else:
                vals = np.asarray(base_values[name], dtype=np.float32)
            ops.append(sp.csr_matrix((tf32(vals), s.indices, s.indptr), shape=s.shape))
        c = (ops[0] @ ops[1]).astype(np.float32).toarray()
        dense[prod.name] = c
        out[prod.name] = torch.from_numpy(c)
    return out


def seed_range(text: str) -> list:
    seeds = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        seeds.extend(range(int(lo), int(hi or lo) + 1))
    return seeds


def program_reading(cell, seed: int, seconds: float) -> dict:
    pool, order = cell.values(seed)
    cell.warm_up(pool, order, seed)
    sampler = cell.sampler(seed)
    tally = drive.Tally()
    cell.driver.run(pool, order, tally, sampler, deadline=time.perf_counter() + seconds)
    samples = [(drive.host_copy(pool[k]), outputs) for k, outputs in sampler.kept]
    checks = judge.judge(cell.inst, samples, cell.cfg["limits"])
    return {"seed": seed, "requests": tally.requests, "compared": len(samples), "checks": checks}


def control_reading(cell, seed: int) -> dict:
    pool, _ = cell.values(seed)
    picks = drive.rng(seed, 3).choice(len(pool), size=min(cell.traffic["sample"], len(pool)),
                                      replace=False)
    samples = []
    for k in picks:
        values = drive.host_copy(pool[int(k)])
        samples.append((values, cell.recorder(control_outputs(cell.inst, values))))
    checks = judge.judge(cell.inst, samples, cell.cfg["limits"])
    return {"seed": seed, "compared": len(samples), "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seed_range, default=[])
    ap.add_argument("--control-seeds", type=seed_range, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    add_program_path()
    from spgemm_bench.harness import Cell

    device = torch.device(args.device)
    t = time.perf_counter()
    cell = Cell(args.workload, device)
    record = {"workload": args.workload, "setup_s": time.perf_counter() - t,
              "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
              "program": [], "control": []}
    for seed in args.seeds:
        record["program"].append(program_reading(cell, seed, args.seconds))
        print(json.dumps({"program": record["program"][-1]}), flush=True)
    for seed in args.control_seeds:
        record["control"].append(control_reading(cell, seed))
        print(json.dumps({"control": record["control"][-1]}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
