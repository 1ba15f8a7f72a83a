#!/usr/bin/env python3
"""Time the port's grouped expert GEMM (K3) and its gradient kernels on one card.

At Qwen3-MoE-235B-A22B's expert widths (E = 128, d = 4,096, f = 1,536,
bf16, operands drawn from a seed): the forward ``expert_wgmma`` at the
capacities the main paths give it (C = 640, 320, 160 and 1, and 32 experts
at C = 1, the EP decode step's share of a rank), and the training path's
gradient products at C = 320, ``expert_wgmma_dx`` (dx = dy @ wᵀ) and
``expert_wgmma_dw`` (dw = xᵀ @ dy), for both orientations of the
projections (the up projections' (d, f) = (4,096, 1,536) and the down
projection's (1,536, 4,096)).  Each launch is held to its plain version
(``kernels.ref``) by ``chip_smoke``'s rules, then timed by CUDA events
(``chip_smoke.cuda_ms``) beside ``torch.bmm`` on the same operands; the
bound is every operand read once and the output written once at 3.35 TB/s
against bf16 operations at 989 TFLOP/s.  One JSON line a case, then the
card's name and power limit.

Run from the repository root on a machine with a CUDA card:

    python3 tools/time_k3_grad.py --src src

``--src`` may name the ``src`` directory of another checkout (an unpacked
``git archive``): its ``repro_torch`` is imported and its kernels are built
there, so two trees can be timed at the same shapes on the same card (run
them in turns: parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
E, D, F = 128, 4096, 1536
FORWARD = ((E, 640, D, F), (E, 320, D, F), (E, 320, F, D), (E, 160, D, F), (E, 1, D, F),
           (32, 1, D, F))
GRAD = ((E, 320, D, F), (E, 320, F, D))  # (E, C, d, f): x (E, C, d), w (E, d, f)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", required=True, help="the src directory whose repro_torch to time")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import torch

    import chip_smoke as cs
    import repro_torch.kernels.moe_gemm as k3
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import moe_gemm_ref

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    for line in _build.build("moe_gemm")[1].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas[moe_gemm] {line.strip()}", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    tol = cs.TOL["bfloat16"]
    peak = "bfloat16"

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(torch.bfloat16)

    def emit(rec):
        rec["src"] = str(src)
        print(json.dumps(rec), flush=True)

    for shape in FORWARD:
        e, c, d, f = shape
        x, w = normal((e, c, d), 1.0), normal((e, d, f), d ** -0.5)
        k3.moe_gemm.launches["expert_wgmma"] = 0
        got = k3.moe_gemm(x, w, c, f, d)
        torch.cuda.synchronize()
        if k3.moe_gemm.launches["expert_wgmma"] != 1:
            cs.fail(f"forward at {shape}: {k3.moe_gemm.launches}")
        err = cs.max_err_within(got, moe_gemm_ref(x, w), tol, f"forward at {shape}")
        n_bytes = (x.numel() + w.numel() + e * c * f) * 2
        bound_ms, bound_by = cs.bound(n_bytes, 2.0 * e * c * d * f, peak)
        emit({"kernel": "expert_wgmma", "shape": list(shape), "max_abs_err": err,
              "ms": cs.cuda_ms(lambda: k3.moe_gemm(x, w, c, f, d), reps=args.reps),
              "library_ms": cs.cuda_ms(lambda: torch.bmm(x, w), reps=args.reps),
              "bound_ms": bound_ms, "bound_by": bound_by})
        del x, w, got

    for shape in GRAD:
        e, c, d, f = shape
        x, w, dy = normal((e, c, d), 1.0), normal((e, d, f), d ** -0.5), normal((e, c, f), 1e-3)
        if hasattr(k3, "_grad"):
            dx_fn = lambda: k3._grad("expert_wgmma_dx", w, dy, c, d, f)  # noqa: E731
            dw_fn = lambda: k3._grad("expert_wgmma_dw", x, dy, c, d, f)  # noqa: E731
        else:  # a tree whose gradients are layouts of the forward kernel
            dx_fn = lambda: k3._wgmma("expert_wgmma_dx", dy, w, c, f, d)  # noqa: E731
            dw_fn = lambda: k3._wgmma("expert_wgmma_dw", x, dy, d, c, f)  # noqa: E731
        cases = {
            "dx": (dx_fn, lambda: moe_gemm_ref(dy, w.transpose(1, 2)),
                   lambda: torch.bmm(dy, w.transpose(1, 2)), w.numel()),
            "dw": (dw_fn, lambda: moe_gemm_ref(x.transpose(1, 2), dy),
                   lambda: torch.bmm(x.transpose(1, 2), dy), x.numel()),
        }
        for name, (kernel, plain, library, other) in cases.items():
            before = k3.moe_gemm.launches[f"expert_wgmma_{name}"]
            got = kernel()
            torch.cuda.synchronize()
            if k3.moe_gemm.launches[f"expert_wgmma_{name}"] != before + 1:
                cs.fail(f"{name} at {shape} launched {k3.moe_gemm.launches}")
            want = plain()
            cs.rule_rejects(want, tol, f"{name} at {shape}", cs.grad_scale(want),
                            ("the next expert's", 0))
            err = cs.grad_err_within(got, want, tol, f"{name} at {shape}")
            del got, want
            out_elems = e * c * d if name == "dx" else e * d * f
            n_bytes = (other + dy.numel() + out_elems) * 2
            bound_ms, bound_by = cs.bound(n_bytes, 2.0 * e * c * d * f, peak)
            emit({"kernel": f"expert_wgmma_{name}", "shape": list(shape), "max_abs_err": err,
                  "ms": cs.cuda_ms(kernel, reps=args.reps),
                  "library_ms": cs.cuda_ms(library, reps=args.reps),
                  "bound_ms": bound_ms, "bound_by": bound_by})
        del x, w, dy
    print(card, flush=True)


if __name__ == "__main__":
    main()
