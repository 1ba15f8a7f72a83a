"""Collectives of the executors.

``Loopback`` runs all p ranks of a plan on one device, stacked along a
leading rank axis — the port's counterpart of XLA's forced host devices, and
enough to drive every rank of a plan through one card.  A
``torch.distributed`` backend for one rank per card comes in a later slice.
"""
from __future__ import annotations

import torch


class Loopback:
    """All p ranks stacked on one device along axis 0.

    A batched executor's collective (``batch=m``) takes stacks with one more
    leading axis, the m value sets of a dispatch, and counts every set it
    moves: ``m`` times the items of one set, padding sets included.
    """

    def __init__(self, p: int, batch: int | None = None):
        self.p = p
        self.batch = batch
        self.items_moved = 0  # items exchanged since ``reset``
        # the leading dims every stack has: (sets,) when batched, then ranks
        self._want = (p, p) if batch is None else (batch, p, p)

    def _rank_axis(self, buf: torch.Tensor, what: str) -> int:
        """Axis of the source ranks in ``buf``; checks the stack's shape."""
        if buf.shape[: len(self._want)] != self._want:
            dims = ", ".join(str(d) for d in self._want)
            raise ValueError(f"expected a ({dims}, {what}, ...) buffer; got {tuple(buf.shape)}")
        return len(self._want) - 2

    def all_to_all(self, buf: torch.Tensor, n_items: int) -> torch.Tensor:
        """Personalized exchange of a ``(p_src, p_dst, T, ...)`` send stack.

        Returns the ``(p_dst, p_src, T, ...)`` receive stack: rank d gets
        slot ``[s, d]`` of every sender s — ``jax.lax.all_to_all(...,
        split_axis=1, concat_axis=1, tiled=False)`` on each rank's
        ``(p, T, ...)`` buffer.  ``n_items`` is the number of slots of one
        value set that are not padding, a constant of the route the caller
        counts once.
        """
        axis = self._rank_axis(buf, "T")
        self.items_moved += n_items * (self.batch or 1)
        return buf.transpose(axis, axis + 1)

    def psum_scatter(self, buf: torch.Tensor) -> torch.Tensor:
        """Reduce-scatter of a ``(p_src, p, rows, ...)`` stack of partial
        sums: returns the ``(p, rows, ...)`` stack whose rank d holds the sum
        over sources of chunk d — ``jax.lax.psum_scatter(..., tiled=False)``
        on each rank's ``(p, rows, ...)`` buffer.  Every source ships its
        chunks for the other p - 1 ranks whole, so the ``(p - 1) / p`` of the
        stack that leaves its rank is counted, padding rows included.
        """
        axis = self._rank_axis(buf, "rows")
        self.items_moved += buf.numel() // self.p * (self.p - 1)
        return buf.sum(axis)

    def all_gather(self, buf: torch.Tensor, members: torch.Tensor) -> torch.Tensor:
        """All-gather within groups of ranks: ``buf`` is the ``(p, ...)``
        stack of each rank's block, ``members`` a ``(p, g)`` index tensor
        whose row d lists, in order, the ranks of d's group (d among them).
        Returns the ``(p, g, ...)`` stack whose rank d holds its group's
        blocks — ``jax.lax.all_gather(..., tiled=False)`` over one axis of a
        grid.  Each rank receives the ``g - 1`` blocks of the others, so
        ``p (g - 1)`` blocks are counted, every element of each.
        """
        lead = 0 if self.batch is None else 1
        if buf.shape[lead] != self.p or members.shape[0] != self.p:
            raise ValueError(f"expected {self.p} ranks; got {tuple(buf.shape)} "
                             f"and members {tuple(members.shape)}")
        block = buf[0].numel() if self.batch is None else buf[0, 0].numel()
        self.items_moved += self.p * (members.shape[1] - 1) * block * (self.batch or 1)
        return buf[members] if self.batch is None else buf[:, members]

    def reset(self) -> None:
        self.items_moved = 0
