"""The JAX package's parameter tree as the port's parameters, and a rank's
share of a tree for expert parallelism.

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


EXPERT_WEIGHTS = ("wi", "wg", "wo")  # the MoE layers' (n_layers, E, ...) stacks


def expert_shard(params: dict, rank: int, tp: int) -> dict:
    """Rank ``rank``'s parameters for expert parallelism over ``tp`` ranks
    (``moe_layer``'s ``ep_group``): the MoE layers' expert weights cut to
    experts ``[rank E / tp, (rank + 1) E / tp)`` as copies, so the full
    tree can be freed; every other leaf (the router among them) is the
    full tree's own tensor.  Takes the port's tree or one made by
    ``params_from_reference``."""
    moe = params["layers"]["moe"]
    E = moe["wi"].shape[1]
    if E % tp or not 0 <= rank < tp:
        raise ValueError(f"no rank {rank} of {tp} expert-parallel ranks over {E} experts")
    part = slice(rank * E // tp, (rank + 1) * E // tp)
    shard = {k: v[:, part].clone() if k in EXPERT_WEIGHTS else v for k, v in moe.items()}
    return {**params, "layers": {**params["layers"], "moe": shard}}
