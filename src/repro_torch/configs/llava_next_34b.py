"""LLaVA-NeXT-34B [hf:llava-hf/llava-v1.6]: VLM; anyres-tiling vision frontend
is a STUB (input_specs supplies precomputed patch embeddings); backbone is a
dense GQA decoder."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    d_head=128,
    act="swiglu",
    norm="rms",
    frontend="vision",
)
SMOKE = CONFIG.scaled_down()
