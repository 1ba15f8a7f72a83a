"""InternLM2-1.8B [arXiv:2403.17297]: dense, GQA kv=8, SwiGLU, RMSNorm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92544,
    d_head=128,
    act="swiglu",
    norm="rms",
)
SMOKE = CONFIG.scaled_down()
