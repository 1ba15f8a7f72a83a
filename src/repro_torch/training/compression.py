"""Error-feedback int8 gradient compression (the port of
``repro.training.compression``).

``compressed_psum_mean``: quantize -> all_reduce (int32 accumulate) ->
dequantize, returning the mean across a process group plus the new local
error, so the quantization error is re-injected next step (EF-SGD /
1-bit-Adam lineage).  Where the reference runs inside ``shard_map`` over a
mesh axis, this runs in each process of a ``torch.distributed`` group
(``launch.ranks.run_ranks``), with the same two reductions, rounding and
clipping.  It needs no training step.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.comm import all_reduce


def compressed_psum_mean(
    x: torch.Tensor,
    err: torch.Tensor,
    group,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean of ``x + err`` over the ranks of ``group`` using int8 wire
    format.  Returns (mean, new_error), both fp32."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    xe = x.float() + err
    # scales differ per participant: agree on the group-max scale (one
    # scalar MAX) so a single int32 reduction is exact w.r.t. the shared scale
    scale = torch.clamp(xe.abs().max(), min=1e-12) / 127.0
    smax = all_reduce(scale, group, "max")
    q = torch.clamp(torch.round(xe / smax), -127, 127).to(torch.int32)
    acc = all_reduce(q, group, "sum")
    mean = acc.float() * smax / n
    # xe - q * smax with one rounding, as the reference's compiled update
    # has it (XLA fuses the multiply and the subtract); exact in float64
    new_err = (xe.double() - q.double() * smax.double()).float()
    return mean, new_err


def compression_ratio(dtype=torch.bfloat16) -> float:
    """Bytes of ``dtype`` over the int8 wire format's."""
    return dtype.itemsize / torch.int8.itemsize
