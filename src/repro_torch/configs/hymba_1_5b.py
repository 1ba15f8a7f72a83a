"""Hymba-1.5B [arXiv:2411.13676]: hybrid — parallel attention + Mamba heads in
every layer; sliding-window attention (the paper's 3 global-attention layers
are approximated as SWA to keep the scanned layer stack uniform — DESIGN.md
§Arch-applicability).  Sub-quadratic: runs long_500k."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    d_head=64,
    layer_kind="hybrid",
    sliding_window=2048,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    act="swiglu",
    norm="rms",
)
SMOKE = CONFIG.scaled_down()
