"""DBRX-132B [hf:databricks/dbrx-base]: 40L, GQA kv=8, 16 experts top-4
(fine-grained), expert d_ff=10752."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=0,
    vocab=100352,
    d_head=128,
    act="swiglu",
    norm="layer",
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
)
SMOKE = CONFIG.scaled_down()
