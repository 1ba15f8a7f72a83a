"""StarCoder2-15B [arXiv:2402.19173]: dense, GQA kv=4, RoPE, GeLU, LayerNorm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    d_head=128,
    act="gelu",
    norm="layer",
    use_rope=True,
    qkv_bias=True,
    mlp_bias=False,
)
SMOKE = CONFIG.scaled_down()
