"""Falcon-Mamba-7B [arXiv:2410.05355]: pure Mamba-1, attention-free, no FFN
sub-block (d_ff=0), ssm_state=16.  Sub-quadratic: runs long_500k."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    n_layers=64,
    d_model=4096,
    n_heads=1,       # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,          # no FFN sub-block
    vocab=65024,
    d_head=64,
    layer_kind="mamba",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    norm="rms",
    use_rope=False,
)
SMOKE = CONFIG.scaled_down(d_ff=0)
