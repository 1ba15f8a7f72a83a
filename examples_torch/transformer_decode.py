"""Example: batched transformer decode over the training substrate.

Prefill a prompt batch, then decode token by token, the KV cache updated in
place (``training.step.make_decode_step``).  Greedy by default; with
``--temperature`` above 0 each token is drawn from the softmax of the
logits over the temperature by a ``torch.Generator`` seeded from
``--seed``.  ``--model-parallel`` above 1 builds ``make_host_mesh`` over
the process group and distributes the parameters by ``param_shardings``, as
``launch.train`` does.

Usage (a reduced config, on the card; ``--device cpu`` for the CPU):
  PYTHONPATH=src python examples_torch/transformer_decode.py \
      --arch internlm2-1.8b --smoke --batch 4 --prompt-len 64 --decode-tokens 32
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import all_arch_ids, get_config, get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_params
from repro_torch.models.sharding import (
    batch_sharding,
    distribute,
    distribute_params,
    param_shardings,
)
from repro_torch.training.step import make_decode_step, make_prefill_step


def load(cfg, seed: int, device, model_parallel: int = 1):
    """(parameters, mesh or None): ``init_params`` from ``seed`` on
    ``device``, distributed over a (data, model) host mesh when
    ``model_parallel`` is above 1."""
    params = init_params(cfg, seed, device=device)
    if model_parallel <= 1:
        return params, None
    mesh = make_host_mesh(model=model_parallel, device_type=device.type)
    return distribute_params(params, mesh, param_shardings(cfg, mesh)), mesh


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompts: np.ndarray, decode_tokens: int, temperature: float = 0.0,
             seed: int = 0, mesh=None) -> dict:
    """Prefill ``prompts`` (B, S) int32, then ``decode_tokens - 1`` decode
    steps on the device ``params`` lie on.  Returns the tokens (B,
    decode_tokens), the prefill's logits, and the two phases' seconds."""
    device = params["embed"]["tokens"].device
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    tokens = torch.as_tensor(prompts, dtype=torch.int32, device=device)
    if mesh is not None:
        tokens = distribute(tokens, batch_sharding(mesh, tokens.shape[0], tokens.ndim))
    gen = torch.Generator(device=device).manual_seed(seed)

    def pick(logits):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen).to(torch.int32)
        return logits.argmax(-1)[:, None].to(torch.int32)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens})
    _sync(device)
    t_prefill = time.perf_counter() - t0

    first = logits
    tok = pick(logits)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for _ in range(decode_tokens - 1):
        logits, cache = decode(params, cache, tok)
        tok = pick(logits)
        out_tokens.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    toks = torch.cat(out_tokens, dim=1)
    if mesh is not None:  # whole, on every rank
        toks, first = toks.full_tensor(), first.full_tensor()
    return {"tokens": toks, "prefill_logits": first, "prefill_s": t_prefill,
            "decode_s": t_decode}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=all_arch_ids())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-tokens", type=int, default=32)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params, mesh = load(cfg, args.seed, device, args.model_parallel)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    out = generate(cfg, params, prompts, args.decode_tokens, args.temperature, args.seed, mesh)
    total = args.batch * (args.decode_tokens - 1)
    print(
        f"prefill {args.batch}x{args.prompt_len} in {out['prefill_s']:.2f}s | "
        f"decode {total} tokens in {out['decode_s']:.2f}s "
        f"({total/max(out['decode_s'],1e-9):.1f} tok/s)"
    )
    toks = out["tokens"]
    print("first sequence:", toks[0, :16].tolist())
    return toks


if __name__ == "__main__":
    main()
