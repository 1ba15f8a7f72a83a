"""Training substrate (the port of ``repro.training``): optimizers, the
train and serve step builders, and the compressed all-reduce."""
from repro_torch.training.compression import compressed_psum_mean, compression_ratio
from repro_torch.training.optimizer import (
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
)
from repro_torch.training.step import make_decode_step, make_prefill_step, make_train_step

__all__ = [
    "adamw_init",
    "adamw_update",
    "adafactor_init",
    "adafactor_update",
    "make_train_step",
    "make_prefill_step",
    "make_decode_step",
]
