"""Command-R-35B [hf:CohereForAI/c4ai-command-r-v01]: dense, GQA kv=8,
no-bias, parallel attention+FFN block, LayerNorm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    d_head=128,
    act="swiglu",
    norm="layer",
    parallel_block=True,
    tie_embeddings=True,
)
SMOKE = CONFIG.scaled_down()
