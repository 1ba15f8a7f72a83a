"""Phi-3-mini-3.8B [arXiv:2404.14219]: dense, kv=32 (MHA), RoPE, SwiGLU."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    d_head=96,
    act="swiglu",
    norm="rms",
)
SMOKE = CONFIG.scaled_down()
