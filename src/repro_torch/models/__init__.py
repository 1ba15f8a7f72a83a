"""Model stack (the port of ``repro.models``): the decoder of every layer
kind (attention, Mamba, hybrid) — init, forward (with activation
checkpointing), ``train_loss``, decode step, KV and SSM cache — on one
device."""
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.transformer import (
    init_params,
    init_kv_cache,
    forward,
    train_loss,
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
    "train_loss",
    "decode_step",
    "param_count",
    "active_param_count",
]
