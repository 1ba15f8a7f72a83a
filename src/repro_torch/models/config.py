"""Model configuration.

One ``ModelConfig`` describes any architecture in the assigned pool: dense
GQA transformers, MoE, pure-SSM (Mamba-1), hybrid attention+SSM, and stubbed
modality frontends (VLM / audio: the backbone consumes precomputed
frame/patch embeddings through ``input_specs``).

A copy of ``repro.models.config``: every field is kept.
``seq_shard_residual``, ``gather_weights`` and ``kv_shard_mode`` are the
reference's sharding settings: under a mesh (``models.sharding``) they
act as there (the residual split over the sequence between layers, each
layer's weights gathered to their TP sharding before use, the decode KV
cache pinned by batch or split over its slots); outside one they change
nothing.  ``scan_unroll`` is the reference's compile setting, accepted
and ignored (the port's dry run runs every layer).  ``remat_policy``
picks ``forward``'s activation checkpointing, as in the reference.
The port runs every ``layer_kind``: ``"attn"``, ``"mamba"`` (Mamba-1
selective SSM) and ``"hybrid"`` (attention and SSM heads in parallel,
averaged).
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    router_aux_coef: float = 0.01
    # expert permutation from the hypergraph comm planner (beyond-paper);
    # None = identity placement
    expert_placement: tuple[int, ...] | None = None


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2  # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    layer_kind: Literal["attn", "mamba", "hybrid"] = "attn"
    act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm: Literal["rms", "layer"] = "rms"
    rope_theta: float = 10_000.0
    use_rope: bool = True
    qkv_bias: bool = False
    mlp_bias: bool = False
    parallel_block: bool = False  # attn & MLP in parallel (command-r style)
    tie_embeddings: bool = False
    sliding_window: int = 0  # 0 = full attention
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    frontend: Literal["none", "vision", "audio"] = "none"
    # sub-quadratic? (drives long_500k applicability)
    dtype: str = "bfloat16"
    # dry-run only: unroll the layer scan so cost_analysis / the collective
    # census see every layer (XLA counts while-loop bodies once)
    scan_unroll: bool = False
    # perf knobs (EXPERIMENTS.md §Perf): activation-checkpoint policy and
    # sequence-parallel residual stream (saved activations sharded over
    # 'model' between layers)
    remat_policy: str = "nothing"  # "nothing" | "dots" | "none"
    seq_shard_residual: bool = False
    # gather FSDP-sharded weights at use point (ZeRO-3 semantics) instead of
    # letting XLA all-reduce partially-computed activations
    gather_weights: bool = False
    # KV-cache sharding inside decode: "none" (baseline: XLA free to regather)
    # | "batch" (pin batch sharding) | "seq" (cache length over 'model' —
    # distributed flash-decode; softmax stats reduced across columns)
    kv_shard_mode: str = "batch"

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def subquadratic(self) -> bool:
        return self.layer_kind == "mamba" or (
            self.layer_kind == "hybrid" and self.sliding_window > 0
        )

    @property
    def d_inner(self) -> int:
        ssm = self.ssm or SSMConfig()
        return ssm.expand * self.d_model

    def scaled_down(self, **overrides) -> "ModelConfig":
        """Reduced config of the same family for CPU smoke tests."""
        base = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128,
            vocab=256,
            d_head=16,
            layer_kind=self.layer_kind,
            act=self.act,
            norm=self.norm,
            rope_theta=self.rope_theta,
            use_rope=self.use_rope,
            qkv_bias=self.qkv_bias,
            mlp_bias=self.mlp_bias,
            parallel_block=self.parallel_block,
            tie_embeddings=self.tie_embeddings,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            moe=(
                MoEConfig(
                    n_experts=4,
                    top_k=min(self.moe.top_k, 2),
                    d_ff_expert=64,
                    capacity_factor=self.moe.capacity_factor,
                    n_shared_experts=self.moe.n_shared_experts,
                )
                if self.moe
                else None
            ),
            ssm=SSMConfig(d_state=8, d_conv=4, expand=2) if self.ssm else None,
            frontend=self.frontend,
            dtype="float32",
        )
        base.update(overrides)
        return ModelConfig(**base)
