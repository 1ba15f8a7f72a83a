#!/usr/bin/env python3
"""Time K1's ``scalar_runs`` (1 x 1 x 1 blocks) of any tree on one card.

On the inputs of the six ``scalar_runs`` rows of ``chip_smoke.py``'s
kernels line: monoC at p = 4 on 27-AP (n = 42; all four ranks' lists in
one launch), rank 0's lists of monoC on 27-PTAP (n = 42) and of
``compile(batch=8)`` monoC on LP-pds100 (8 sets), monoC on MCL-dip at
scale 0.2 (all ranks), and the whole products MCL-facebook at scale 1
squared and 27-AP at n = 63 (``chip_smoke.k1_paper_inputs``).  The monoC
lists are the executor's (``spgemm_exec.MonoCStep`` of the plan, for the
ranks it holds), the tables fp32 N(0, 1) values from a seed.  Each row:
the kernel against its plain version (1e-4), its time by CUDA-graph
replay (``chip_smoke.graph_ms`` of ``launch`` into a zeroed C), the
wrapper's call by events (``bsr_spgemm_local``: C's allocation, and its
fill where the tree fills it, then the launch), the plain version's time
and ``chip_smoke.kernel_bound``.  One JSON line a row, then the card's name
and power limit.

Run from the repository root on a machine with a CUDA card:

    python3 tools/time_k1_scalar.py --src src

``--src`` may name the ``src`` directory of another checkout (an unpacked
``git archive``): its ``repro_torch`` is imported and its kernels are built
there, so two trees are timed on the same card (run them in turns:
parent, change, change, parent).  The inputs are planned once and kept in
``--cache`` (under ``build/``), so every turn times the same lists.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ROWS = ("scalar_runs", "scalar_runs@ranks", "scalar_runs@ranks_batched", "scalar_runs@mcl",
        "scalar_runs@mcl_facebook", "scalar_runs@amg63")


def monoC_inputs(inst, ranks, batch, rng):
    """K1's arguments in a monoC step at p = 4 that holds ``ranks``, on
    CPU tensors (random tables of the step's sizes)."""
    import torch
    import repro_torch
    from repro_torch.distributed.spgemm_exec import MonoCStep

    plan = repro_torch.plan(inst, p=4, model="monoC", seed=0).execution_plan
    step = MonoCStep(plan, 1, "cpu", batch, comm=SimpleNamespace(ranks=list(ranks)))
    size = (batch or 1) * len(ranks)
    tables = [torch.from_numpy(rng.standard_normal(size * n).astype(np.float32)).view(-1, 1, 1)
              for n in (plan.a_table_slots, plan.b_table_slots)]
    return (*tables, step.pair_a, step.pair_b, step.pair_c, step.run_start, step.run_c,
            step.n_c_blocks)


def build_inputs(cs) -> dict:
    """Every row's arguments on CPU tensors, from seed 0."""
    from repro_torch.core.matrices import amg_instances, lp_instance, mcl_instance

    rng = np.random.default_rng(0)
    ap, ptap = amg_instances(42)
    inputs = {
        "scalar_runs": monoC_inputs(ap, range(4), None, rng),
        "scalar_runs@ranks": monoC_inputs(ptap, [0], None, rng),
        "scalar_runs@ranks_batched": monoC_inputs(lp_instance("pds100"), [0], 8, rng),
        "scalar_runs@mcl": monoC_inputs(mcl_instance("dip", 0.2), range(4), None, rng),
    }
    for key, _ in cs.K1_PAPER:
        inputs[f"scalar_runs@{key}"] = cs.k1_paper_inputs(cs.k1_paper_instance(key), "cpu",
                                                          rng)[0]
    return inputs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", required=True, help="the src directory whose repro_torch to time")
    parser.add_argument("--cache", default=str(ROOT / "build" / "time_k1_scalar.pt"),
                        help="where the planned inputs are kept between runs")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local, launch
    from repro_torch.kernels.ref import bsr_spgemm_ref

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script runs only on the card")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    for line in _build.build("bsr_spgemm")[1].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas[bsr_spgemm] {line.strip()}", flush=True)
    cache = Path(args.cache)
    if cache.exists():
        inputs = torch.load(cache)
    else:
        inputs = build_inputs(cs)
        cache.parent.mkdir(parents=True, exist_ok=True)
        torch.save(inputs, cache)
    for row in ROWS:
        kargs = tuple(x.to(device) if isinstance(x, torch.Tensor) else x for x in inputs[row])
        a, b, pa, pb, pc, rs, rc, n_c = kargs
        before = bsr_spgemm_local.launches["scalar_runs"]
        got = bsr_spgemm_local(*kargs)
        torch.cuda.synchronize()
        if bsr_spgemm_local.launches["scalar_runs"] != before + 1:
            cs.fail(f"{row}: {bsr_spgemm_local.launches}")
        err = cs.max_err_within(got, bsr_spgemm_ref(a, b, pa, pb, pc, n_c), cs.TOL["float32"], row)
        out = torch.zeros_like(got)
        bound_ms, bound_by, n_bytes, _, _ = cs.kernel_bound(a, b, pa, pb, rs, rc)
        lengths = (rs[1:] - rs[:-1]).float()
        print(json.dumps({
            "row": row, "src": str(src), "pairs": pa.numel(), "runs": rc.numel(),
            "mean_run": float(lengths.mean()), "max_run": int(lengths.max()),
            "max_abs_err": err, "ms": cs.graph_ms(lambda: launch(a, b, pa, pb, rs, rc, out),
                                                  reps=args.reps),
            "call_ms": cs.cuda_ms(lambda: bsr_spgemm_local(*kargs), reps=args.reps),
            "plain_ms": cs.cuda_ms(lambda: bsr_spgemm_ref(a, b, pa, pb, pc, n_c), reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": n_bytes,
        }), flush=True)
        del kargs, a, b, pa, pb, pc, rs, rc, got, out
        torch.cuda.empty_cache()
    print(card, flush=True)


if __name__ == "__main__":
    main()
