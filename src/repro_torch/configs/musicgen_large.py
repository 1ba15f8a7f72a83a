"""MusicGen-large [arXiv:2306.05284]: decoder-only over EnCodec tokens
(vocab 2048).  The EnCodec frontend is a stub — inputs are already token ids.
Positional encoding: RoPE stands in for the paper's sinusoidal embeddings
(DESIGN.md assumption note)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    d_head=64,
    act="gelu",
    norm="layer",
    frontend="audio",
)
SMOKE = CONFIG.scaled_down()
