"""Training substrate (the port of ``repro.training``): so far the serve
step builders; the optimizers, ``make_train_step`` and compression wait for
the training slice (ROADMAP.md Queue 1 item 8b)."""
from repro_torch.training.step import make_prefill_step, make_decode_step

__all__ = ["make_prefill_step", "make_decode_step"]
