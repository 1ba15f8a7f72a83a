"""Qwen3-MoE-235B-A22B [hf:Qwen family]: 94L, GQA kv=4, 128 experts top-8,
expert d_ff=1536, no shared expert.  The MoE dispatch is the SpGEMM the
hypergraph comm planner (repro_torch.core.moe_planner) optimizes."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=0,          # all-MoE FFN (no dense/shared branch)
    vocab=151936,
    d_head=128,
    act="swiglu",
    norm="rms",
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
)
SMOKE = CONFIG.scaled_down()
