#!/usr/bin/env python3
"""Time the port's Qwen3-MoE training step on one card.

Qwen3-MoE-235B-A22B at its published width, bf16, cut to 2 of its 94
layers (as ``chip_smoke.py`` phase 14 (a)), random weights from seed 0,
Adafactor, ``SyntheticTokens`` 4 x 1,024 tokens a step (C = 320 rows an
expert): ``launch.train.build_trainer``'s step run 7 times, the first a
warm-up, each ended by ``torch.cuda.synchronize`` and timed on the host's
clock.  Prints one JSON line (the step times, their median, tokens a
second and the K3 launches of the last step), then the card's name and
power limit.

Run from the repository root on a machine with a CUDA card:

    python3 tools/time_train_step.py --src src

``--src`` may name the ``src`` directory of another checkout (an unpacked
``git archive``), so two trees can be timed on the same card in one call
(in turns: parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH, LAYERS, BATCH, SEQ, STEPS = "qwen3-moe-235b-a22b", 2, 4, 1024, 7


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", required=True, help="the src directory whose repro_torch to time")
    src = Path(parser.parse_args().src).resolve()
    sys.path.insert(0, str(src))
    import torch

    import repro_torch.kernels.moe_gemm as k3
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import init_params

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs only on the card")
    device = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=LAYERS)
    step, opt_init = build_trainer(cfg, device, optimizer="adafactor")
    params = init_params(cfg, 0, device=device)
    state = opt_init(params)
    data = SyntheticTokens(cfg.vocab, SEQ, BATCH, seed=0)
    ms = []
    for i in range(STEPS):
        batch = {k: torch.as_tensor(v, device=device) for k, v in data.batch(i).items()}
        for name in k3.moe_gemm.launches:
            k3.moe_gemm.launches[name] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        loss = float(metrics["loss"])
        if loss != loss:
            sys.exit(f"step {i}: loss {loss}")
    median = statistics.median(ms[1:])
    print(json.dumps({"src": str(src), "arch": ARCH, "n_layers": LAYERS,
                      "tokens_per_step": BATCH * SEQ, "step_ms": ms, "step_ms_median": median,
                      "tokens_per_s": BATCH * SEQ / (median / 1e3),
                      "k3_launches": {k: v for k, v in k3.moe_gemm.launches.items() if v}}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
