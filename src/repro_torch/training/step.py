"""Serve step builders (the serving half of ``repro.training.step``): the
LM stack's entry points on one device.  Each step runs where its
parameters lie (``init_params`` puts them on the card unless told
otherwise) and records no autograd graph.  ``make_train_step`` waits for
the training slice (ROADMAP.md Queue 1 item 3)."""
from __future__ import annotations

import torch

from repro_torch.models import decode_step
from repro_torch.models.transformer import prefill_step


def make_prefill_step(cfg, ep_group=None):
    """Returns step(params, batch) -> (last-token logits (B, V), KV cache);
    with ``ep_group`` the MoE layers run expert-parallel over its ranks
    (``transformer.prefill_step``)."""

    @torch.no_grad()
    def step(params, batch):
        return prefill_step(params, cfg, batch, ep_group)

    return step


def make_decode_step(cfg):
    """Returns step(params, cache, tokens) -> (logits (B, V), cache); the
    cache is updated in place (``transformer.decode_step``)."""

    @torch.no_grad()
    def step(params, cache, tokens):
        return decode_step(params, cfg, cache, tokens)

    return step
