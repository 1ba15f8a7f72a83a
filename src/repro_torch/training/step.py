"""Train and serve step builders (the port of ``repro.training.step``): the
LM stack's entry points on one device.  Each step runs where its
parameters lie (``init_params`` puts them on the card unless told
otherwise).  The serve steps record no autograd graph; the train step
records one for its loss and updates the parameters in place
(``training.optimizer``)."""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import decode_step, train_loss
from repro_torch.models.sharding import lies, mesh_ops, set_mesh
from repro_torch.models.transformer import prefill_step
from repro_torch.training.optimizer import OPTIMIZERS, chunk_slices, tree_leaves, tree_map


def _clip_(grads, clip: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``clip`` (fp32
    sum of squares over the leaves, each leaf rounded once to its type, as
    the reference's ``(g.astype(f32) * scale).astype(g.dtype)``); returns
    the norm before clipping."""
    leaves = tree_leaves(grads)
    sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        if isinstance(g, DTensor):  # a sum over its shards, on every rank
            sq += g.float().square().sum().full_tensor()
            continue
        g = g.view(-1)
        for i, j in chunk_slices(g.numel(), 1):
            sq += g[i:j].float().square().sum()
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in leaves:  # elementwise: a DTensor's shards scale as they lie
        g = (g.to_local() if isinstance(g, DTensor) else g).view(-1)
        for i, j in chunk_slices(g.numel(), 1):
            g[i:j] = g[i:j].float() * scale
    return gnorm


def _laid_as(g, p):
    """The gradient ``g`` of ``p`` as ``p`` lies: a DTensor gradient that
    DTensor left partial or placed otherwise is redistributed (the
    data-parallel reduction)."""
    if isinstance(g, DTensor) and lies(g) != lies(p):
        return g.redistribute(p.device_mesh, lies(p))
    return g.contiguous()


def _scope(params):
    """The step's context: the mesh of the parameters' DTensors ambient
    (``set_mesh``; plain parameters keep whatever is ambient) and
    ``mesh_ops``."""
    stack = contextlib.ExitStack()
    first = tree_leaves(params)[0]
    if isinstance(first, DTensor):
        stack.enter_context(set_mesh(first.device_mesh))
    stack.enter_context(mesh_ops())
    return stack


def make_train_step(cfg, optimizer: str = "adamw", lr: float = 3e-4, clip: float = 1.0):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).

    The full production step: forward and backward (``train_loss``, layers
    checkpointed by ``cfg.remat_policy``), global-norm clip, update.  The
    parameters and the optimizer state are updated in place and returned;
    ``metrics`` holds ``loss``, ``grad_norm``, ``nll`` and ``aux`` as 0-d
    tensors on the parameters' device (reading one waits for the card).
    With DTensor parameters (``models.sharding``) their mesh is ambient in
    the step, the state and the batch are DTensors on it too, each
    gradient is brought to its parameter's placements before the clip, and
    the metrics are DTensors."""
    _, opt_update = OPTIMIZERS[optimizer]

    def step(params, opt_state, batch):
        with _scope(params):
            # gradients of fresh leaves that share the parameters' storage, so
            # the caller's tensors keep requires_grad off
            leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
            with torch.enable_grad():
                loss, metrics = train_loss(leaves, cfg, batch)
                flat = tree_leaves(leaves)
                grads = torch.autograd.grad(loss, flat, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else _laid_as(g, p)
                     for p, g in zip(flat, grads)]
            del leaves, flat
            with torch.no_grad():
                gnorm = _clip_(grads, clip)
                it = iter(grads)
                grads = tree_map(lambda _: next(it), params)
                params, opt_state = opt_update(grads, opt_state, params, lr=lr)
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics.update(loss=loss.detach(), grad_norm=gnorm)
            return params, opt_state, metrics

    return step


def make_prefill_step(cfg, ep_group=None):
    """Returns step(params, batch) -> (last-token logits (B, V), KV cache);
    with ``ep_group`` the MoE layers run expert-parallel over its ranks
    (``transformer.prefill_step``); on DTensor parameters, under their
    mesh."""

    @torch.no_grad()
    def step(params, batch):
        with _scope(params):
            return prefill_step(params, cfg, batch, ep_group)

    return step


def make_decode_step(cfg, ep_group=None):
    """Returns step(params, cache, tokens) -> (logits (B, V), cache); the
    cache is updated in place (``transformer.decode_step``); with
    ``ep_group`` the MoE layers run expert-parallel over its ranks; on
    DTensor parameters, under their mesh."""

    @torch.no_grad()
    def step(params, cache, tokens):
        with _scope(params):
            return decode_step(params, cfg, cache, tokens, ep_group)

    return step
