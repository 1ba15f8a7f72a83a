"""Hand-written Hopper kernels (``csrc/``), their wrappers and their plain
PyTorch versions (``ref``).  A kernel that fails on the card raises
``KernelError``."""

from repro_torch.kernels._build import KernelError

__all__ = ["KernelError"]
