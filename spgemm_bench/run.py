"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 spgemm_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Needs a CUDA card: without one, or with fewer
than the cell asks for, it exits 2 and prints no result.  The last line of
standard output is the result's JSON object; the last lines of standard
error are the numbers compared, each beside its limit.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # the JAX package and what it runs on


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from spgemm_bench.spec import Spec, add_program_path

    spec = Spec(ROOT)
    chips = spec.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    add_program_path(ROOT)
    from spgemm_bench.harness import run_cell

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T0, spec)
    bad = loaded_forbidden()
    if bad:
        print(f"modules of the JAX package loaded in the run: {bad}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        ok = "ok" if check["value"] <= check["limit"] else "FAIL"
        print(f"check {name} {check['value']!r} limit {check['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
