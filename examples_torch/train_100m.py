"""End to end: train a ~100M-parameter decoder for a few hundred
steps on the synthetic pipeline, with checkpointing + restart.

  PYTHONPATH=src python examples_torch/train_100m.py --steps 300               # on the card
  PYTHONPATH=src python examples_torch/train_100m.py --steps 3 --device cpu    # plain PyTorch

The model is the internlm2 family scaled to ~100M params (d=768, 12 layers,
16k vocab, fp32).  Loss should drop well below the uniform baseline
ln(16384)=9.70 within the first tens of steps (the synthetic stream has Zipf
unigrams + repeated motifs worth >4 nats).  ``launch.elastic.run_loop``
writes a checkpoint every 50 steps to ``--ckpt-dir`` and resumes from the
latest one it finds there, so a second run on the same directory goes on
where the first stopped.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.elastic import run_loop
from repro_torch.models import init_params, param_count
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import adamw_init, tree_map
from repro_torch.training.step import make_train_step

CKPT_EVERY = 50


def model_100m() -> ModelConfig:
    return dataclasses.replace(
        get_config("internlm2-1.8b"),
        name="repro-100m",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        d_head=64,
        d_ff=3072,
        vocab=16384,
        dtype="float32",
    )


def train(cfg, args, device, params=None, failure_injector=None):
    """``args.steps`` AdamW steps of ``cfg`` through ``run_loop`` on
    ``device``, from ``params`` (``init_params`` with seed 0 unless given)
    or from the latest checkpoint in ``args.ckpt_dir``.  Logs every 10th
    step and the last to stdout and ``args.log``.  Returns the parameters,
    the optimizer state, the loop's stats, the logged records and every
    run step's loss by step."""
    step = make_train_step(cfg, lr=args.lr)
    if params is None:
        params = init_params(cfg, 0, device=device)
    opt = adamw_init(params)
    data = SyntheticTokens(
        vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.global_batch, seed=0
    )
    os.makedirs(os.path.dirname(args.log) or ".", exist_ok=True)
    records, losses = [], {}
    t_start = time.time()

    def step_fn(state, idx):
        p, o = state
        batch = {k: torch.as_tensor(v, device=device) for k, v in data.batch(idx).items()}
        p, o, m = step(p, o, batch)
        loss = losses[idx] = float(m["loss"])
        if idx % 10 == 0 or idx == args.steps - 1:
            rec = {
                "step": idx,
                "loss": round(loss, 4),
                "grad_norm": round(float(m["grad_norm"]), 3),
                "wall_s": round(time.time() - t_start, 1),
            }
            print(rec, flush=True)
            with open(args.log, "a") as logf:
                logf.write(json.dumps(rec) + "\n")
            records.append(rec)
        return p, o

    (params, opt), stats = run_loop(
        (params, opt),
        step_fn,
        args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=CKPT_EVERY,
        failure_injector=failure_injector,
        state_to_tree=lambda s: {"p": s[0], "o": s[1]},
        tree_to_state=lambda t, s: tuple(
            tree_map(lambda new, old: new.to(old.device), t[k], old)
            for k, old in zip(("p", "o"), s)
        ),
    )
    print(f"finished {stats.steps_run} steps ({stats.restarts} restarts)")
    return {"params": params, "opt": opt, "stats": stats, "records": records, "losses": losses}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_100m_ckpt"))
    ap.add_argument("--log", default=os.path.join(ROOT, "chiprun_out", "train_100m.jsonl"))
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = model_100m()
    n = param_count(cfg)
    print(f"model {cfg.name}: {n/1e6:.1f}M params, uniform nll={math.log(cfg.vocab):.3f}")
    return train(cfg, args, device)


if __name__ == "__main__":
    main()
