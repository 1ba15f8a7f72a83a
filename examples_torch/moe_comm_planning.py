"""MoE dispatch planning (the paper's technique inside the LM framework).

Profiles routing on a smoke MoE model, builds the dispatch-SpGEMM hypergraph,
partitions it into expert columns, and compares the planned placement's
communication/load metrics against the naive contiguous placement — then
re-runs the model with the placement installed, its expert products on the
grouped expert GEMM (``kernels.moe_gemm.GroupedGemm``).

  PYTHONPATH=src python examples_torch/moe_comm_planning.py               # on the card
  PYTHONPATH=src python examples_torch/moe_comm_planning.py --device cpu  # plain PyTorch
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core.moe_planner import plan_expert_placement, routing_counts
from repro_torch.models import init_params, train_loss
from repro_torch.models.config import MoEConfig


def smoke_moe_config():
    """A 16-expert smoke MoE (Qwen3-MoE's smoke config, 16 experts of
    width 64, top 2)."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    return dataclasses.replace(cfg, moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=64))


def run(cfg, params) -> dict:
    """Plan a placement for correlated synthetic routing, print it beside
    the contiguous one, and run ``train_loss`` with it installed on the
    device ``params`` lie on.  Returns the plan and the loss."""
    # profile routing: correlated synthetic gate decisions
    rng = np.random.default_rng(0)
    T, E, K = 8192, 16, 2
    scattered = rng.permutation(E).reshape(4, 4)
    gate = np.empty((T, K), dtype=np.int64)
    for t in range(T):
        gate[t] = rng.choice(scattered[(t * 4) // T], size=K, replace=False)

    counts = routing_counts(gate, E, n_groups=64)
    plan = plan_expert_placement(counts, n_columns=4)
    print("dispatch-SpGEMM hypergraph planning (4 expert columns):")
    print(f"  cut cost  : contiguous={plan.comm_contiguous}  planned={plan.comm_planned}")
    print(f"  load imbal: contiguous={plan.load_imbalance_contiguous:.3f}  "
          f"planned={plan.load_imbalance_planned:.3f}")
    print(f"  placement : {plan.placement.tolist()}")

    cfg2 = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, expert_placement=tuple(plan.placement))
    )
    device = params["embed"]["tokens"].device
    batch = {
        "tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)), dtype=torch.int32,
                                  device=device),
        "labels": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)), dtype=torch.int32,
                                  device=device),
    }
    with torch.no_grad():
        loss, _ = train_loss(params, cfg2, batch)
    loss = float(loss)
    print(f"model runs with planned placement: loss={loss:.4f}")
    return {"plan": plan, "loss": loss}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    cfg = smoke_moe_config()
    return run(cfg, init_params(cfg, 0, device=resolve_device(args.device)))


if __name__ == "__main__":
    main()
