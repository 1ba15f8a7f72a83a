"""Training substrate (the port of ``repro.training``): so far the serve
step builders and the compressed all-reduce; the optimizers and
``make_train_step`` wait for the training slice (ROADMAP.md Queue 1
item 3)."""
from repro_torch.training.compression import compressed_psum_mean, compression_ratio
from repro_torch.training.step import make_prefill_step, make_decode_step

__all__ = ["compressed_psum_mean", "compression_ratio", "make_prefill_step", "make_decode_step"]
