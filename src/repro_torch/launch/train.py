"""End-to-end training driver (the port of ``repro.launch.train``).

Usage (a reduced config, on the card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --smoke \
      --steps 50 --ckpt-dir /tmp/ckpt

The reference's flags, plus ``--device`` (the card unless ``--device
cpu``).  One device runs the whole model: where the reference builds a
mesh and shards the parameters over it, this takes a device, and
``--model-parallel`` above 1 raises until sharding is ported (ROADMAP.md
Queue 1 item 5).  The loop is ``launch.elastic.run_loop``: checkpointed
every ``--ckpt-every`` steps, restarted from the latest checkpoint on a
retryable failure.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import all_arch_ids, get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.elastic import run_loop
from repro_torch.models import init_params
from repro_torch.training.optimizer import OPTIMIZERS, tree_map
from repro_torch.training.step import make_train_step

SHARDING_ROADMAP = "ROADMAP.md Queue 1 item 5 (NCCL on 4 cards, with sharding)"


def build_trainer(cfg, device, lr=3e-4, optimizer="adamw"):
    """(step, opt_init) for ``cfg`` on ``device``: ``make_train_step``'s
    step (parameters and optimizer state updated in place, on the device
    they lie on) and the optimizer's init.  The reference also returns the
    parameters' shardings; one device has none."""
    resolve_device(device)
    opt_init, _ = OPTIMIZERS[optimizer]
    return make_train_step(cfg, optimizer=optimizer, lr=lr), opt_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=all_arch_ids())
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: the port trains on one device; "
            f"sharding waits for {SHARDING_ROADMAP}"
        )

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    step, opt_init = build_trainer(cfg, device, lr=args.lr, optimizer=args.optimizer)
    params = init_params(cfg, args.seed, device=device)
    opt_state = opt_init(params)

    data = SyntheticTokens(
        vocab=cfg.vocab,
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        seed=args.seed,
    )

    def step_fn(state, idx):
        params, opt_state = state
        batch = {k: torch.as_tensor(v, device=device) for k, v in data.batch(idx).items()}
        params, opt_state, metrics = step(params, opt_state, batch)
        if idx % 5 == 0 or idx == args.steps - 1:
            print(
                f"step {idx:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f}",
                flush=True,
            )
        return params, opt_state

    to_device = lambda tree: tree_map(lambda t: t.to(device), tree)
    t0 = time.time()
    (params, opt_state), stats = run_loop(
        (params, opt_state),
        step_fn,
        args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        state_to_tree=lambda s: {"params": s[0], "opt": s[1]},
        tree_to_state=lambda t, s: (to_device(t["params"]), to_device(t["opt"])),
    )
    dt = time.time() - t0
    toks = args.steps * args.global_batch * args.seq_len
    print(
        f"done: {stats.steps_run} steps, {stats.restarts} restarts, "
        f"{toks/dt:.0f} tok/s, {len(stats.stragglers)} straggler events"
    )
    return params


if __name__ == "__main__":
    main()
