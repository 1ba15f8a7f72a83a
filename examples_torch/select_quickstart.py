"""Model selection in 30 seconds: pick the cheapest SpGEMM algorithm.

Partitions every hypergraph model of a small AMG instance (the 27-point
stencil Galerkin product A·P), reports each model's predicted communication
next to the words its lowered execution plan actually schedules, and runs
every executor on the card against the dense oracle, so predicted ==
measured is checked on live traffic.  Everything goes through the
``repro_torch.api`` front door; the sweep table comes from
``sweep_instance`` (the same selection ``model="auto"`` runs).

    PYTHONPATH=src python examples_torch/select_quickstart.py               # on the card
    PYTHONPATH=src python examples_torch/select_quickstart.py --device cpu  # plain PyTorch
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

import repro_torch
from repro_torch._device import resolve_device


def run(inst, p: int = 4, device=None) -> dict:
    """The sweep table of ``inst`` with every executor run on ``device``
    (the card unless named), then the compile-once demo.  Returns the sweep
    records and the demo's record."""
    from repro_torch.distributed.select import sweep_instance

    device = resolve_device(device)
    print(f"instance: {inst.name}  shape={inst.shape}  |V^m|={inst.n_mult}")

    # random values on the fixed structures, for the executor oracle check
    rng = np.random.default_rng(0)

    def valued(struct):
        d = np.zeros(struct.shape, np.float32)
        r, c = struct.coo()
        d[r, c] = rng.standard_normal(len(r)).astype(np.float32)
        return d

    recs = sweep_instance(
        inst, p, a_dense=valued(inst.a), b_dense=valued(inst.b), execute=True, device=device
    )
    print(f"\n{'model':12s} {'predicted':>9s} {'measured':>9s} {'padded':>8s}  notes")
    for r in recs:
        if r["status"] != "ok":
            print(f"{r['model']:12s}  skipped: {r['reason']}")
            continue
        notes = []
        if r["measured_words"] == r["predicted_words"]:
            notes.append("measured == predicted")
        notes.append(f"executor err {r['exec_max_err']:.1e}")
        if r["selected"]:
            notes.append("<== selected")
        print(
            f"{r['model']:12s} {r['predicted_words']:9d} {r['measured_words']:9d} "
            f"{r['padded_words']:8d}  {', '.join(notes)}"
        )

    return {"records": recs, "iterated": iterated_multiply_demo(inst, p, rng, device)}


def iterated_multiply_demo(inst, p: int, rng, device) -> dict:
    """Amortization in action: one ``repro_torch.plan`` handle, compiled
    once, then many same-structure multiplies as value-only updates (the
    AMG/MCL pattern — one partition, many products).  Each call goes
    through the handle, so it asks the runtime's executor LRU again: its
    misses, the port's counterpart of the reference's retraces, must not
    move after the compile."""
    from repro_torch.distributed.runtime import cache_info

    # plan + compile ONCE, from the structures alone (no dense operands)
    spgemm = repro_torch.plan(inst.a, inst.b, p=p, model="fine", name=inst.name)
    t0 = time.perf_counter()
    spgemm.compile(device=device)
    cold = time.perf_counter() - t0
    misses = cache_info()["misses"]
    # many multiplies on the fixed structure: values only, no new executor
    iters = 10
    products = []
    t0 = time.perf_counter()
    for _ in range(iters):
        a_vals = rng.standard_normal(inst.a.nnz).astype(np.float32)
        b_vals = rng.standard_normal(inst.b.nnz).astype(np.float32)
        products.append((a_vals, b_vals, spgemm(a_vals, b_vals, device=device)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    per_call = (time.perf_counter() - t0) / iters
    new_misses = cache_info()["misses"] - misses
    print(
        f"\ncompile-once runtime (fine, p={p}): compile {cold * 1e3:.0f} ms once, "
        f"then {per_call * 1e6:.0f} us/multiply over {iters} same-structure calls "
        f"({new_misses} LRU misses); C is dense, trimmed, ready"
    )
    return {"compile_s": cold, "call_us": per_call * 1e6, "calls": iters,
            "lru_misses": new_misses, "handle": spgemm, "products": products}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    from repro_torch.core.matrices import amg_instances

    # 27-pt stencil A·P at n=6 (216 rows)
    return run(amg_instances(6)[0], p=4, device=args.device)


if __name__ == "__main__":
    main()
