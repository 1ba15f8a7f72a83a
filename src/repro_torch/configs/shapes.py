"""Assigned input-shape set for the LM-family architectures (the port of
``repro.configs.shapes``).

Each shape names a workload kind:
- train_4k:     train_step,  seq 4,096 x global_batch 256
- prefill_32k:  serve prefill, seq 32,768 x batch 32
- decode_32k:   serve decode (1 new token, KV cache 32,768), batch 128
- long_500k:    long-context decode, cache 524,288, batch 1
                (sub-quadratic archs only; full-attention archs skip)

``input_specs`` and ``cache_specs`` return tensors on the ``meta`` device
(shape and dtype, no storage) where the reference returns
``jax.ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig

VISION_FRONT_TOKENS = 576  # one anyres tile of patch embeddings (stub)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention (DESIGN.md §long_500k)."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "full quadratic attention: 500k decode KV infeasible"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _spec(shape: str | ShapeSpec) -> ShapeSpec:
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def input_specs(cfg: ModelConfig, shape: str | ShapeSpec) -> dict:
    """Meta-device stand-ins for every model input of this cell (``shape``
    a name of ``SHAPES`` or a ``ShapeSpec``)."""
    spec = _spec(shape)
    B, S = spec.global_batch, spec.seq_len
    i32 = torch.int32
    act = getattr(torch, cfg.dtype)
    out: dict = {}
    n_front = VISION_FRONT_TOKENS if cfg.frontend == "vision" else 0
    if spec.kind in ("train", "prefill"):
        if n_front:
            out["frontend_embeds"] = _meta((B, n_front, cfg.d_model), act)
        out["tokens"] = _meta((B, S - n_front), i32)
        if spec.kind == "train":
            out["labels"] = _meta((B, S - n_front), i32)
    else:  # decode: one new token + the cache (cache specs built separately)
        out["tokens"] = _meta((B, 1), i32)
    return out


def cache_specs(cfg: ModelConfig, shape: str | ShapeSpec) -> dict:
    """Meta-device tensors for the KV/SSM cache at this decode shape."""
    from repro_torch.models.transformer import init_kv_cache

    spec = _spec(shape)
    return init_kv_cache(cfg, spec.global_batch, spec.seq_len, device="meta")
