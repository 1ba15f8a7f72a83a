"""AMG case study (paper Sec. 6.1 / Fig. 7, reduced scale).

Compares the seven parallelization classes for both Galerkin-product
SpGEMMs (A@P, P^T@(AP)) against geometric baselines, and prints the
paper's headline conclusions from OUR measured numbers.  The study is host
planning (``repro_torch.core``, numpy and scipy), so its tables are the
same on either device; ``--device`` is resolved as in the other examples.

  PYTHONPATH=src python examples_torch/amg_partition_study.py [--n 9] [--p 8] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch._device import resolve_device
from repro_torch.core import build_model, evaluate, partition
from repro_torch.core.matrices import amg_instances, geometric_row_partition
from repro_torch.core.spgemm_models import MODELS


def study(n: int, p: int) -> dict:
    """The tables and the Sec. 6.1 check for the AMG instances of grid side
    ``n`` at ``p`` parts; returns the max part costs by (kind, model)."""
    ap_inst, ptap_inst = amg_instances(n)
    geo = geometric_row_partition(n, p)
    results = {}
    for inst, kind in ((ap_inst, "AP"), (ptap_inst, "PTAP")):
        print(f"\n== {inst.name} ==")
        for model in MODELS:
            hg = build_model(inst, model)
            if hg.n_pins > 4_000_000:
                print(f"{model:11s} skipped ({hg.n_pins} pins)")
                continue
            res = partition(hg, p, eps=0.10, seed=0)
            c = evaluate(hg, res.parts, p)
            results[(kind, model)] = c.max_part_cost
            print(f"{model:11s} max-part-cost={c.max_part_cost:8d} imb={c.comp_imbalance:.2f}")
        # geometric baseline
        model = "rowwise" if kind == "AP" else "outer"
        hg = build_model(inst, model)
        c = evaluate(hg, geo, p)
        results[(kind, "geometric")] = c.max_part_cost
        print(f"{'geo-' + model:11s} max-part-cost={c.max_part_cost:8d}")

    print("\n== paper-claim check (Sec. 6.1) ==")
    rw, out = results[("AP", "rowwise")], results[("AP", "outer")]
    print(f"A@P: row-wise {rw} vs outer {out} -> row-wise sufficient: {rw <= 2 * out}")
    rw, out = results[("PTAP", "rowwise")], results[("PTAP", "outer")]
    print(f"PTAP: outer {out} vs row-wise {rw} -> outer wins by {rw / max(out,1):.1f}x")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=9, help="grid side (N^3 points)")
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    return study(args.n, args.p)


if __name__ == "__main__":
    main()
