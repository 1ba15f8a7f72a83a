"""The JAX package's parameter tree as the port's parameters.

``params_from_reference`` is the one place that knows the mapping between
the two trees.  The port keeps the reference's tree (the same nested keys,
layers stacked on the leading axis, the same shapes and dtypes), so the
mapping is leaf for leaf; it takes the tree as numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module imports nothing of
jax.  The tests use it to make both packages compute with the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: jax's arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_reference(tree: dict, device=None) -> dict:
    """The port's parameters (a dict tree of tensors on ``device``, the card
    unless named) from the reference's parameter tree of numpy arrays."""
    device = resolve_device(device)
    return {
        k: params_from_reference(v, device) if isinstance(v, dict) else _tensor(np.asarray(v), device)
        for k, v in tree.items()
    }
