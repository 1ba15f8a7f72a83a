"""Collectives of the executors: two transports, one contract.

``Loopback`` runs all p ranks of a plan in one process, stacked along a
leading rank axis on one device — the port's counterpart of XLA's forced
host devices, and enough to drive every rank of a plan through one card.
``GroupComm`` runs one rank per process over a ``torch.distributed``
process group, so each process holds only its own rank's tables: a route
that left out an item some rank reads gives a wrong product there, where
``Loopback`` would still find the item in the stack.

Every stack an executor hands a collective leads with the ranks its
process holds (``comm.ranks``: all p under ``Loopback``, one under
``GroupComm``); where a buffer is addressed to peers, the next axis is the
peer rank.  ``items_moved`` counts the items this process sends, so the
counts of a group's processes sum to ``Loopback``'s for the same calls.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _on_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` where gloo can read it.  gloo moves host memory, so a card
    tensor is copied to a pinned host buffer: this is the one copy to the
    host, and each caller's ``.to(device)`` the one back (NCCL takes the
    card's tensors and drops both).  A CPU tensor is returned as it is."""
    if t.device.type != "cuda":
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over the ranks of ``group`` (``op`` "sum" or "max"), as a
    new tensor on ``x``'s device: one ``torch.distributed.all_reduce``."""
    import torch.distributed as dist

    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    buf = _on_host(x) if x.device.type == "cuda" else x.clone()  # reduced in place
    dist.all_reduce(buf, op=ops[op], group=group)
    return buf.to(x.device)


class Loopback:
    """All p ranks stacked on one device along axis 0.

    A batched executor's collective (``batch=m``) takes stacks with one more
    leading axis, the m value sets of a dispatch, and counts every set it
    moves: ``m`` times the items of one set, padding sets included.
    """

    def __init__(self, p: int, batch: int | None = None):
        self.p = p
        self.batch = batch
        self.ranks = tuple(range(p))  # every rank lives in this process
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
        value set that are not padding, summed over the ranks held, a
        constant of the route the caller counts once.
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

    def gather_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The ``(p, ...)`` stack of every rank's shard: here, ``x`` itself."""
        return x

    def reset(self) -> None:
        self.items_moved = 0


class GroupComm:
    """One rank of a ``torch.distributed`` process group in this process.

    Rank r of the group is rank r of the plan, and the group's size must be
    the plan's p (``make_comm`` checks it).  Each collective is one
    ``all_to_all_single`` of raw bytes, so the contract is the backend's:
    gloo through the host today, NCCL on the card later, with nothing to
    change but the staging in ``_on_host``.

    A batched executor's stacks (``batch=m``) lead with the m value sets of
    a dispatch, ``(m, 1, p, ...)``.  Each collective still makes one
    exchange for all of them: the rows leave destination first,
    ``(p, m, ...)``, and the received rows are put back in the set-major
    order.  ``items_moved`` counts every set this rank sends, padding sets
    included, so the ranks' counts sum to ``Loopback(p, m)``'s.
    """

    def __init__(self, group, batch: int | None = None):
        import torch.distributed as dist

        self.group = group
        self.p = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = (self.rank,)
        self.batch = batch
        self._lead = () if batch is None else (batch,)
        self.items_moved = 0  # items this rank sent since ``reset``

    def _exchange(self, send: torch.Tensor, to: list[int] | None = None,
                  frm: list[int] | None = None) -> torch.Tensor:
        """One ``all_to_all_single`` of the rows of ``send`` (leading axis):
        ``to[d]`` rows (in order) for rank d and ``frm[s]`` rows from rank
        s, returned in source order on ``send``'s device; equal splits when
        neither is given.  The rows travel as bytes, whatever their type."""
        import torch.distributed as dist

        item = send.shape[1:]
        row_bytes = math.prod(item) * send.element_size()
        src = send.contiguous().view(torch.uint8).reshape(send.shape[0], row_bytes)
        n_out = send.shape[0] if frm is None else sum(frm)
        on_card = send.device.type == "cuda"
        out = torch.empty((n_out, row_bytes), dtype=torch.uint8, pin_memory=on_card)
        dist.all_to_all_single(out, _on_host(src), frm, to, group=self.group)
        return out.to(send.device).view(send.dtype).reshape(n_out, *item)

    def _to_peers(self, buf: torch.Tensor, what: str) -> torch.Tensor:
        """This rank's ``(*sets, 1, p, ...)`` send stack as ``(p, *sets,
        ...)`` rows, the destination first."""
        want = (*self._lead, 1, self.p)
        if tuple(buf.shape[: len(want)]) != want:
            dims = ", ".join(str(d) for d in want)
            raise ValueError(f"expected a ({dims}, {what}, ...) buffer; got {tuple(buf.shape)}")
        return buf.select(len(self._lead), 0).movedim(len(self._lead), 0)

    def _from_peers(self, recv: torch.Tensor) -> torch.Tensor:
        """Received ``(p_src, *sets, ...)`` rows as this rank's ``(*sets, 1,
        p_src, ...)`` stack."""
        lead = len(self._lead)
        return recv.movedim(0, lead).unsqueeze(lead)

    def all_to_all(self, buf: torch.Tensor, n_items: int) -> torch.Tensor:
        """``Loopback.all_to_all`` for this rank: its ``(*sets, 1, p_dst, T,
        ...)`` send buffer in, the ``(*sets, 1, p_src, T, ...)`` buffer it
        receives out, ordered by source; ``n_items`` is this rank's valid
        slots of one value set."""
        send = self._to_peers(buf, "T")
        self.items_moved += n_items * (self.batch or 1)
        return self._from_peers(self._exchange(send))

    def psum_scatter(self, buf: torch.Tensor) -> torch.Tensor:
        """``Loopback.psum_scatter`` for this rank: one all_to_all of its
        ``(*sets, 1, p, rows, ...)`` chunks, then the sum over sources in
        source order, as ``Loopback`` sums the stack (not the backend's
        reduce-scatter, whose order is its own); returns ``(*sets, 1, rows,
        ...)``.  Counts the p - 1 chunks this rank ships."""
        send = self._to_peers(buf, "rows")
        self.items_moved += buf.numel() // self.p * (self.p - 1)
        return self._exchange(send).sum(0).unsqueeze(len(self._lead))

    def all_gather(self, buf: torch.Tensor, members) -> torch.Tensor:
        """``Loopback.all_gather`` for this rank: ``buf`` is its ``(*sets, 1,
        ...)`` block and ``members`` the whole ``(p, g)`` table.  One
        all_to_all with uneven splits sends the block to each rank whose
        group holds this one and receives the blocks of its own group's
        ranks, returned as ``(*sets, 1, g, ...)`` in ``members``' order.
        Counts the blocks sent to other ranks."""
        members = np.asarray(torch.as_tensor(members).cpu())
        lead = len(self._lead)
        if tuple(buf.shape[: lead + 1]) != (*self._lead, 1) or members.shape[0] != self.p:
            raise ValueError(f"expected this rank's ({', '.join(map(str, self._lead + (1,)))}"
                             f", ...) block and a ({self.p}, g) member table; got "
                             f"{tuple(buf.shape)} and {members.shape}")
        mine = members[self.rank]
        to = [int(self.rank in members[d]) for d in range(self.p)]
        frm = [int(s in mine) for s in range(self.p)]
        block = buf.select(lead, 0)  # (*sets, ...)
        self.items_moved += (sum(to) - 1) * block.numel()
        recv = self._exchange(block.expand(sum(to), *block.shape), to, frm)
        by_source = np.flatnonzero(frm)  # ranks of recv's rows, ascending
        order = torch.as_tensor(np.searchsorted(by_source, mine), device=buf.device)
        return self._from_peers(recv[order])

    def gather_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The ``(*sets, p, ...)`` stack of every rank's ``(*sets, 1, ...)``
        shard, on every rank: one all_to_all of p copies of ``x``.  A
        batched shard may lead with fewer sets than the capacity (a ragged
        dispatch's, trimmed), the same on every rank.  Assembles a result,
        so it is not counted in ``items_moved``."""
        lead = 0 if self.batch is None else 1
        shard = x.select(lead, 0)
        recv = self._exchange(shard.expand(self.p, *shard.shape))  # (p, *sets, ...)
        return recv.movedim(0, lead)

    def reset(self) -> None:
        self.items_moved = 0


def make_comm(p: int, batch: int | None = None, group=None):
    """The collective of an executor for a p-rank plan, for ``batch`` value
    sets a dispatch (None: one, with no set axis): ``Loopback`` (all ranks
    in this process) without a group, else ``GroupComm`` over it, whose
    size must be p."""
    if group is None:
        return Loopback(p, batch)
    comm = GroupComm(group, batch)
    if comm.p != p:
        raise ValueError(
            f"a plan for p = {p} ranks cannot run over a process group of {comm.p}"
        )
    return comm
