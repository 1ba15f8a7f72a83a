"""End-to-end training driver (the port of ``repro.launch.train``).

Usage (a reduced config, on the card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --smoke \
      --steps 50 --ckpt-dir /tmp/ckpt
Sharded over 4 processes (gloo), a (2, 2) (data, model) mesh, on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --smoke \
      --ranks 4 --model-parallel 2 --device cpu

The reference's flags, plus ``--device`` (the card unless ``--device
cpu``) and ``--ranks`` (start that many processes, one rank each, through
``launch.ranks.run_ranks``, as ``launch.serve --ranks`` does).  With
``--ranks`` or ``--model-parallel`` above 1, the run builds
``make_host_mesh(model=...)`` over the processes' group, as the reference
does over its devices, and distributes the parameters by
``param_shardings`` and each batch by ``batch_sharding`` (DTensors);
otherwise one device runs the whole model.  The loop is
``launch.elastic.run_loop``: checkpointed every ``--ckpt-every`` steps
(whole tensors, gathered from the shards and written by rank 0, so either
package, and a run on any mesh, restores them), restarted from the latest
checkpoint on a retryable failure.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch._device import resolve_device
from repro_torch.configs import all_arch_ids, get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.checkpoint import save_checkpoint
from repro_torch.launch.elastic import run_loop
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_params
from repro_torch.models.sharding import (
    batch_sharding,
    distribute,
    distribute_params,
    full_tree,
    param_shardings,
)
from repro_torch.training.optimizer import OPTIMIZERS, tree_map
from repro_torch.training.step import make_train_step

def build_trainer(cfg, device, lr=3e-4, optimizer="adamw"):
    """(step, opt_init) for ``cfg`` on ``device``: ``make_train_step``'s
    step (parameters and optimizer state updated in place, on the device
    they lie on; DTensor parameters under their mesh) and the optimizer's
    init.  The reference also returns the parameters' shardings
    (``models.sharding.param_shardings``)."""
    resolve_device(device)
    opt_init, _ = OPTIMIZERS[optimizer]
    return make_train_step(cfg, optimizer=optimizer, lr=lr), opt_init


def _value(t) -> float:
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def _laid_like(new, old, device):
    """A restored leaf ``new`` on ``device``, distributed as the live leaf
    ``old`` lies when that is a DTensor (every rank read the same file)."""
    new = new.to(device)
    if isinstance(old, DTensor):
        return distribute_tensor(new, old.device_mesh, old.placements, src_data_rank=None)
    return new


def _train(args, device):
    """The training run on this process (one rank of ``--ranks``, or the
    only process); returns the parameters (with a mesh, gathered whole)."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = None
    if args.ranks or args.model_parallel > 1:
        mesh = make_host_mesh(model=args.model_parallel, device_type=device.type)
    step, opt_init = build_trainer(cfg, device, lr=args.lr, optimizer=args.optimizer)
    params = init_params(cfg, args.seed, device=device)
    if mesh is not None:
        params = distribute_params(params, mesh, param_shardings(cfg, mesh))
    opt_state = opt_init(params)

    data = SyntheticTokens(
        vocab=cfg.vocab,
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        seed=args.seed,
    )

    def put(v):
        t = torch.as_tensor(v, device=device)
        return t if mesh is None else distribute(t, batch_sharding(mesh, t.shape[0], t.ndim))

    def step_fn(state, idx):
        params, opt_state = state
        batch = {k: put(v) for k, v in data.batch(idx).items()}
        params, opt_state, metrics = step(params, opt_state, batch)
        if idx % 5 == 0 or idx == args.steps - 1:  # every rank: a DTensor's read is a collective
            loss, gnorm = _value(metrics["loss"]), _value(metrics["grad_norm"])
            if _is_root():
                print(f"step {idx:5d} loss {loss:.4f} gnorm {gnorm:.3f}", flush=True)
        return params, opt_state

    def to_state(tree, state):
        return tuple(tree_map(lambda new, old: _laid_like(new, old, device), t, s)
                     for t, s in zip((tree["params"], tree["opt"]), state))

    t0 = time.time()
    (params, opt_state), stats = run_loop(
        (params, opt_state),
        step_fn,
        args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        state_to_tree=lambda s: {"params": full_tree(s[0]), "opt": full_tree(s[1])},
        tree_to_state=to_state,
        save=save_checkpoint if _is_root() else lambda *a, **k: None,
    )
    dt = time.time() - t0
    toks = args.steps * args.global_batch * args.seq_len
    if _is_root():
        print(
            f"done: {stats.steps_run} steps, {stats.restarts} restarts, "
            f"{toks/dt:.0f} tok/s, {len(stats.stragglers)} straggler events"
        )
    return params if mesh is None else full_tree(params)


def _is_root() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _train_rank(group, device, args):
    """One rank of ``--ranks``: its run's parameters, whole, as numpy
    arrays on rank 0 (nothing elsewhere)."""
    params = _train(args, device)
    return tree_map(lambda t: t.cpu().numpy(), params) if _is_root() else None


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
    ap.add_argument("--ranks", type=int, default=0,
                    help="processes to start, one rank each (launch.ranks.run_ranks, gloo)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if not args.ranks:
        return _train(args, device)
    import tempfile

    from repro_torch.launch.ranks import run_ranks

    with tempfile.TemporaryDirectory(prefix="train_ranks_") as workdir:
        results = run_ranks(_train_rank, args.ranks, device=device, workdir=workdir,
                            args=(args,))
    return tree_map(torch.from_numpy, results[0].result)


if __name__ == "__main__":
    main()
