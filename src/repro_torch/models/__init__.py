"""Model stack (the port of ``repro.models``): the attention-family decoder
— init, prefill forward, decode step, KV cache — on one device.  The
reference's ``train_loss`` waits for the training slice (ROADMAP.md Queue 1
item 3)."""
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.transformer import (
    init_params,
    init_kv_cache,
    forward,
    decode_step,
    param_count,
    active_param_count,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "init_params",
    "init_kv_cache",
    "forward",
    "decode_step",
    "param_count",
    "active_param_count",
]
