"""Collectives of the executors.

``Loopback`` runs all p ranks of a plan on one device, stacked along a
leading rank axis — the port's counterpart of XLA's forced host devices, and
enough to drive every rank of a plan through one card.  A
``torch.distributed`` backend for one rank per card comes in a later slice.
"""
from __future__ import annotations

import torch


class Loopback:
    """All p ranks stacked on one device along axis 0."""

    def __init__(self, p: int):
        self.p = p
        self.items_moved = 0  # non-padding items exchanged since ``reset``

    def all_to_all(self, buf: torch.Tensor, n_items: int) -> torch.Tensor:
        """Personalized exchange of a ``(p_src, p_dst, T, ...)`` send stack.

        Returns the ``(p_dst, p_src, T, ...)`` receive stack: rank d gets
        slot ``[s, d]`` of every sender s — ``jax.lax.all_to_all(...,
        split_axis=1, concat_axis=1, tiled=False)`` on each rank's
        ``(p, T, ...)`` buffer.  ``n_items`` is the number of slots that are
        not padding, a constant of the route the caller counts once.
        """
        if buf.shape[:2] != (self.p, self.p):
            raise ValueError(
                f"expected a ({self.p}, {self.p}, T, ...) buffer; got {tuple(buf.shape)}"
            )
        self.items_moved += n_items
        return buf.transpose(0, 1)

    def reset(self) -> None:
        self.items_moved = 0
