"""The device an entry point runs on.

A leaf module (torch only, nothing of ``repro_torch``) so that every layer
— the partitioner in ``core`` as much as the runtime in ``distributed`` —
resolves its device the same way without importing the layers above it.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  ``None`` means CUDA and raises when there is none — the CPU is
    only ever chosen explicitly (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
