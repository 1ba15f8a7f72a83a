"""Executor phase: the paper's SpGEMM algorithms in PyTorch.

This mirrors ``repro.distributed.spgemm_exec``.  A step runs the ranks its
collective holds (``comm.ranks``): all p stacked on one device under
``comm.Loopback`` (the default), or this process's one rank under
``comm.GroupComm``, each process holding only its own rank's tables.  The
same loops run either way, over the held ranks:

- ``RowwiseStep``: 1D row-wise (Ex. 5.1) — one padded all_to_all of dense
  B rows (exactly the cut B-nets of the partition, plus padding), then each
  rank's dense ``A rows @ (K, J) table`` product.  Columnwise runs it on
  ``C^T = B^T A^T``.
- ``OuterStep``: 1D outer-product (Ex. 5.2) — each rank's dense partial C,
  then a fold phase realized as a reduce-scatter over C row blocks.
- ``MonoCStep``: 2D monochrome-C (Ex. 5.4) — every C (block-)nonzero lives
  on one rank; the cut A-nets and B-nets lower to two padded all_to_all
  expand phases, and local compute streams the plan's pair lists through
  the BSR SpGEMM kernel, so the executor's arithmetic is exactly the
  coarsened multiplication vertices the model counts.
- ``FineStep``: 3D fine-grained (Def. 3.1), and monoA / monoB, whose plans
  are fine plans — two expands, each rank's gather–multiply–segment-add into
  its produced-partial-C table, and a reduce all_to_all of the cut C-nets
  into each C nonzero's owner.

Structure-time vs value-time split (DESIGN.md §8): each step uploads the
route tables, work lists and scatter indices of its held ranks once, with
the -1 padding of the plan's tables dropped there; its call takes
rank-major packed operand tables of those ranks.

Batched steps (``batch=m``, the counterpart of the reference's ``jax.vmap``
over a step): every table carries one more leading axis, the m value sets
of one dispatch, and each step still makes one pass over them.  The flat
index lists a step uploads (route sends, pair lists, scatters) are repeated
once per set, set i's copy offset by i times one set's table size
(``per_set``), so monoC's one K1 launch and fine's gathers and one
``index_add_`` run over all m sets; the 1D models' ``torch.matmul``s take
the set axis as a batch.  An unbatched monoC or fine step has no set axis
at all (its host-paced call dispatches nothing more); the 1D steps, paced
by their dense products, run an unbatched call as a batch of one.

The dense entry points are thin wrappers over
``runtime.compile_spgemm``.  The local dense products and the segment-add
are the reference's jitted XLA (not Pallas) and stay ``torch.matmul`` and
``index_add_``; only monoC's local compute is a hand-written kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.distributed.comm import GroupComm, Loopback, make_comm
from repro_torch.distributed.plan_ir import FinePlan, MonoCPlan, OuterPlan, RowwisePlan
from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local, pair_runs


def _take0(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather leading-axis slices with -1 padding -> zero slices."""
    rows = x[idx.clamp(min=0)]
    mask = (idx >= 0).reshape(idx.shape + (1,) * (x.ndim - 1))
    return torch.where(mask, rows, torch.zeros((), dtype=x.dtype, device=x.device))


def per_set(idx, size: int, batch: int | None) -> np.ndarray:
    """A flat index list into one value set's table, repeated for each set
    of a batch, set i's copy offset by ``i * size``; -1 padding stays -1."""
    idx = np.asarray(idx, dtype=np.int64).ravel()
    if batch is None:
        return idx
    sets = np.arange(batch, dtype=np.int64)[:, None] * size
    return np.where(idx >= 0, idx + sets, -1).ravel()


def _sets(x: torch.Tensor, batch: int | None) -> torch.Tensor:
    """A step's input with its leading value-set axis (one set unbatched)."""
    return x.unsqueeze(0) if batch is None else x


def _unsets(x: torch.Tensor, batch: int | None) -> torch.Tensor:
    """A step's result without the set axis when the step is unbatched."""
    return x[0] if batch is None else x


def _matmul(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, batch: int | None) -> None:
    """``out = a @ b`` over the value-set axis; an unbatched step's one set
    is a 2-D product, so the library picks its kernel as it would unbatched."""
    if batch is None:
        a, b, out = a[0], b[0], out[0]
    torch.matmul(a, b, out=out)


def _exchange(comm: Loopback | GroupComm, buf: torch.Tensor, n_items: int) -> torch.Tensor:
    """``comm.all_to_all`` of a ``(sets, held, p, T, ...)`` stack."""
    return _sets(comm.all_to_all(_unsets(buf, comm.batch), n_items), comm.batch)


def _int32(x: np.ndarray, device) -> torch.Tensor:
    x = np.asarray(x)
    if len(x) and x.max() > np.iinfo(np.int32).max:
        raise ValueError("index exceeds the kernel's int32 range")
    return torch.as_tensor(x.astype(np.int32), device=device)


def _send_route(route, n_own: int, device, batch: int | None, ranks):
    """The sends of the held ``ranks`` as flat indices into their rank-major
    stack of owned tables (``(len(ranks) * n_own, ...)`` a value set; -1
    padding kept, so the send buffer has the padded all_to_all's shape),
    with the number of real items those ranks send of one set and T."""
    send = route.send_idx[list(ranks)]  # (held, p, T) local slots
    src = np.arange(len(ranks), dtype=np.int64)[:, None, None]
    flat = np.where(send >= 0, src * n_own + send, -1)
    return (
        torch.as_tensor(per_set(flat, len(ranks) * n_own, batch), device=device),
        int((send >= 0).sum()),
        send.shape[2],
    )


def _expand(comm: Loopback | GroupComm, own: torch.Tensor, route, lead: tuple) -> torch.Tensor:
    """``[owned | received | zero]`` slot tables of the held ranks (of all
    value sets: ``own`` is (*lead, held, n_own, ...), ``lead`` () or
    (sets,)), flattened set- then rank-major to
    ``(sets * held * table_slots, ...)``: one all_to_all of the owned items
    each rank ships — THE cut-net traffic of this operand."""
    with tracing.span("exec.expand"):
        flat_idx, n_items, T = route
        h, p, item = own.shape[len(lead)], comm.p, own.shape[len(lead) + 2:]
        buf = _take0(own.reshape(-1, *item), flat_idx).reshape(*lead, h, p, T, *item)
        recv = comm.all_to_all(buf, n_items)
        zero = own.new_zeros((*lead, h, 1, *item))
        tables = torch.cat([own, recv.reshape(*lead, h, p * T, *item), zero], len(lead) + 1)
        return tables.reshape(-1, *item)


def _flat(x: np.ndarray, device) -> torch.Tensor:
    """An int64 index tensor: the dense tables of the 1D executors reach
    past 2^31 elements at the AMG sizes."""
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


# ---------------------------------------------------------------------------
# 1D row-wise (Ex. 5.1)
# ---------------------------------------------------------------------------
class RowwiseStep:
    """The row-wise executor core for one plan on one device.

    ``step(a_local, b_local)`` takes rank-major packed dense row tables of
    the held ranks (``comm.ranks``; ``a_local``: (held, I_max, K), rank d's
    A rows; ``b_local``: (held, K_max, J), its B rows) and returns their
    rank-major C rows (held, I_max, J) in plan order
    (``unpack_rowwise_result``); with ``batch=m`` each of them has a leading
    axis of m value sets.  The expand is ONE all_to_all of dense B rows.
    Each rank's (K, J) tables of the B rows it reads are built, multiplied
    and dropped before the next rank's, so memory holds one rank's tables
    at a time, not p.
    """

    def __init__(self, plan: RowwisePlan, K: int, J: int, device, batch: int | None = None,
                 comm=None):
        self.p, self.K, self.J = plan.p, K, J
        self.batch = batch
        self.comm = make_comm(plan.p, batch) if comm is None else comm
        route = plan.routes["expand"]
        local_b = plan.local_b_rows
        self._route = _send_route(route, local_b.shape[1], device, batch, self.comm.ranks)
        # the send buffer is filled by one gather; its padding slots are
        # zeroed after it
        flat_idx = self._route[0]
        self._send_rows = flat_idx.clamp(min=0)
        self._send_pad = torch.nonzero(flat_idx < 0).reshape(-1)
        # per destination rank: which (source, slot) arrivals land on which
        # table rows, and its own rows (a prefix of its owned list)
        self._tables = []
        for d in self.comm.ranks:
            s_ids, t_ids = np.nonzero(route.recv_key[:, d] >= 0)
            n_own = int((local_b[d] >= 0).sum())
            self._tables.append(
                (
                    _flat(s_ids, device),
                    _flat(t_ids, device),
                    _flat(route.recv_key[s_ids, d, t_ids], device),
                    n_own,
                    _flat(local_b[d, :n_own], device),
                )
            )

    def _send_buffer(self, b_local: torch.Tensor) -> torch.Tensor:
        m, h, _, J = b_local.shape
        T = self._route[2]
        buf = b_local.new_empty((m * h * self.p * T, J))
        torch.index_select(b_local.reshape(-1, J), 0, self._send_rows, out=buf)
        buf.index_fill_(0, self._send_pad, 0)
        return buf.reshape(m, h, self.p, T, J)

    def __call__(self, a_local: torch.Tensor, b_local: torch.Tensor) -> torch.Tensor:
        a_local, b_local = _sets(a_local, self.batch), _sets(b_local, self.batch)
        m = a_local.shape[0]
        # THE cut-B-net traffic: (sets, held dst, p_src, T, J) rows from each source
        recv = _exchange(self.comm, self._send_buffer(b_local), self._route[1])
        c = a_local.new_empty((m, len(self._tables), a_local.shape[2], self.J))
        for d, (s_ids, t_ids, keys, n_own, own_keys) in enumerate(self._tables):
            table = b_local.new_zeros((m, self.K, self.J))
            table.index_copy_(1, keys, recv[:, d, s_ids, t_ids])
            table.index_copy_(1, own_keys, b_local[:, d, :n_own])
            _matmul(a_local[:, d], table, c[:, d], self.batch)
            del table  # freed before the next rank's is allocated
        return _unsets(c, self.batch)


def make_rowwise_step(
    plan: RowwisePlan, K: int, J: int, device, batch: int | None = None, comm=None
) -> RowwiseStep:
    """The row-wise executor core (``repro``'s ``make_rowwise_step``), with
    the held ranks' tables uploaded to ``device`` once."""
    return RowwiseStep(plan, K, J, device, batch, comm)


def _dense_call_1d(plan, a_dense, b_dense, device) -> torch.Tensor:
    """Shared dense entry for the 1D executors: derive structures, hit the
    runtime cache, and feed the nonzero values through the executor."""
    from repro_torch.distributed.runtime import compile_spgemm, torch_dtype
    from repro_torch.sparse.structure import from_dense

    a_dense = np.asarray(a_dense)
    b_dense = np.asarray(b_dense)
    a_s, b_s = from_dense(a_dense), from_dense(b_dense)
    exe = compile_spgemm(
        plan,
        a_s,
        b_s,
        device=device,
        dtype=torch_dtype(np.promote_types(a_dense.dtype, b_dense.dtype)),
    )
    return exe(a_dense[a_s.coo()], b_dense[b_s.coo()])


def rowwise_spgemm(a_dense, b_dense, plan: RowwisePlan, device=None) -> torch.Tensor:
    """Sparsity-dependent 1D row-wise SpGEMM.  Returns C rows in plan order
    (rank-major: C[d, r] = row ``plan.local_rows[d, r]``); use
    ``unpack_rowwise_result``.  Runs on the card unless ``device`` names
    another; same-structure calls hit the runtime's cache."""
    return _dense_call_1d(plan, a_dense, b_dense, device)


def make_rowwise_unpack(plan: RowwisePlan, n_rows: int, device):
    """``unpack(c_local) -> dense (n_rows, J)`` with its scatter indices
    uploaded once: rank d's slot r goes to row ``plan.local_rows[d, r]``.
    A leading set axis on ``c_local`` unpacks every set in the same pass."""
    local_rows = plan.local_rows
    dev, slot = np.nonzero(local_rows >= 0)
    rows = _flat(local_rows[dev, slot], device)
    src = _flat(dev * local_rows.shape[1] + slot, device)

    def unpack(c_local: torch.Tensor) -> torch.Tensor:
        J, lead = c_local.shape[-1], c_local.shape[:-3]
        out = c_local.new_zeros((*lead, n_rows, J))
        out[..., rows, :] = c_local.reshape(*lead, -1, J)[..., src, :]
        return out

    return unpack


def unpack_rowwise_result(c_local: torch.Tensor, plan: RowwisePlan, I: int) -> torch.Tensor:
    """Rank-major C rows back to a dense (I, J) tensor on ``c_local``'s
    device."""
    return make_rowwise_unpack(plan, I, c_local.device)(c_local)


# ---------------------------------------------------------------------------
# 1D outer-product (Ex. 5.2)
# ---------------------------------------------------------------------------
class OuterStep:
    """The outer-product executor core for one plan on one device.

    ``step(a_cols, b_rows)`` takes rank-major packed operand tables of the
    held ranks (``a_cols``: (held, I, K_max), rank d's A columns;
    ``b_rows``: (held, K_max, J), its B rows) and returns their C row
    blocks of ceil(I / p), rank-major (held, ceil(I / p), J): each rank's
    dense partial C, zero-padded to p row blocks, folded by one
    reduce-scatter.  With ``batch=m`` each has a leading axis of m value
    sets.
    """

    def __init__(self, plan: OuterPlan, I: int, J: int, batch: int | None = None, comm=None):
        self.p, self.J = plan.p, J
        self.I_pad = (I + plan.p - 1) // plan.p * plan.p
        self.batch = batch
        self.comm = make_comm(plan.p, batch) if comm is None else comm

    def __call__(self, a_cols: torch.Tensor, b_rows: torch.Tensor) -> torch.Tensor:
        a_cols, b_rows = _sets(a_cols, self.batch), _sets(b_rows, self.batch)
        m, h, p, I = a_cols.shape[0], a_cols.shape[1], self.p, a_cols.shape[2]
        partial = a_cols.new_zeros((m, h, self.I_pad, self.J))
        for d in range(h):
            _matmul(a_cols[:, d], b_rows[:, d], partial[:, d, :I], self.batch)
        # fold phase: reduce-scatter C row blocks
        blocks = partial.reshape(m, h, p, self.I_pad // p, self.J)
        return self.comm.psum_scatter(_unsets(blocks, self.batch))


def make_outer_step(plan: OuterPlan, I: int, J: int, batch: int | None = None,
                    comm=None) -> OuterStep:
    """The outer-product executor core (``repro``'s ``make_outer_step``); it
    uploads nothing."""
    return OuterStep(plan, I, J, batch, comm)


def outer_product_spgemm(a_dense, b_dense, plan: OuterPlan, device=None) -> torch.Tensor:
    """1D outer-product SpGEMM: rank d computes sum_{k in K_d} a_:k b_k:, and
    the fold phase reduces partial C over ranks, scattering C row blocks.
    Returns C by row blocks of ceil(I / p), rank-major; ``.reshape(-1, J)[:I]``
    is C.  Runs on the card unless ``device`` names another."""
    return _dense_call_1d(plan, a_dense, b_dense, device)


def spsumma(
    a_dense,
    b_dense,
    grid: tuple[int, int] = (2, 2),
    device=None,
    comm: Loopback | GroupComm | None = None,
) -> torch.Tensor:
    """Dense SUMMA (2D, stationary C) on a ``(pr, pc)`` grid of ranks: rank
    ``(r, c)`` holds block ``(r, c)`` of the zero-padded A and B, gathers
    the A blocks of its grid row and the B blocks of its grid column (the
    volume of the SUMMA panel broadcasts) and multiplies them into its C
    block.  Returns the dense (I, J) product on ``device`` (the card unless
    named); ``comm`` (a ``Loopback`` or ``GroupComm`` over pr * pc ranks,
    default ``Loopback``) runs the ranks it holds and counts the items the
    two all-gathers move.  The C blocks are assembled on every rank by one
    gather that is not counted."""
    from repro_torch.distributed.runtime import resolve_device

    pr, pc = grid
    p = pr * pc
    device = resolve_device(device)
    comm = make_comm(p) if comm is None else comm
    if comm.p != p:
        raise ValueError(f"a ({pr}, {pc}) grid needs {p} ranks; the collective has {comm.p}")
    a = torch.as_tensor(np.asarray(a_dense))
    b = torch.as_tensor(np.asarray(b_dense))
    I, K = a.shape
    _, J = b.shape
    I_p = (I + pr - 1) // pr * pr
    K_p = (K + p - 1) // p * p
    J_p = (J + pc - 1) // pc * pc
    dtype = torch.promote_types(a.dtype, b.dtype)
    a_pad = torch.zeros((I_p, K_p), dtype=dtype, device=device)
    a_pad[:I, :K] = a.to(device)
    b_pad = torch.zeros((K_p, J_p), dtype=dtype, device=device)
    b_pad[:K, :J] = b.to(device)
    # rank r * pc + c holds A block (r, c) of (I_p/pr, K_p/pc) and B block
    # (r, c) of (K_p/pr, J_p/pc)
    held = list(comm.ranks)
    a_blk = a_pad.reshape(pr, I_p // pr, pc, K_p // pc).transpose(1, 2).reshape(p, I_p // pr, -1)
    b_blk = b_pad.reshape(pr, K_p // pr, pc, J_p // pc).transpose(1, 2).reshape(p, K_p // pr, -1)
    r, c = np.divmod(np.arange(p), pc)
    row_ranks = torch.as_tensor(r[:, None] * pc + np.arange(pc)[None, :], device=device)
    col_ranks = torch.as_tensor(np.arange(pr)[None, :] * pc + c[:, None], device=device)
    # (held, pc, I_p/pr, K_p/pc) -> each held rank's (I_p/pr, K_p) A panel row
    h = len(held)
    a_row = comm.all_gather(a_blk[held], row_ranks).transpose(1, 2).reshape(h, I_p // pr, K_p)
    b_col = comm.all_gather(b_blk[held], col_ranks).reshape(h, K_p, J_p // pc)
    c_blk = comm.gather_ranks(torch.matmul(a_row, b_col))  # (p, I_p/pr, J_p/pc)
    out = c_blk.reshape(pr, pc, I_p // pr, J_p // pc).transpose(1, 2).reshape(I_p, J_p)
    return out[:I, :J]


# ---------------------------------------------------------------------------
# 2D monochrome-C (Ex. 5.4)
# ---------------------------------------------------------------------------
class MonoCStep:
    """The monochrome-C executor core for one plan on one device.

    ``step(a_own, b_own)`` takes rank-major packed block tables of the held
    ranks ((held, N_max, b, b)) and returns their rank-major C block slots
    (held, C_max + 1, b, b); the trailing slot per rank is the padding sink
    and stays zero.  Local compute is ONE kernel launch over the held
    ranks' pairs: the i-th held rank's table slots are offset by i times
    the per-rank table size, and the padding pairs (which only ever hit the
    all-zero operand slots and the garbage C slot) are dropped.

    With ``batch=m`` the tables and the result have a leading axis of m
    value sets, and the one launch runs m copies of the pair lists, the
    copy of set i offset by i times the p ranks' table size.  Every C slot
    sums its pairs in the same order in every copy, so set i's result is
    bit for bit the unbatched step's on the same values.
    """

    def __init__(self, plan: MonoCPlan, block: int, device, batch: int | None = None,
                 comm=None):
        p = plan.p
        self.p, self.block, self.device = p, block, torch.device(device)
        self.batch = batch
        self._lead = () if batch is None else (batch,)
        self.comm = make_comm(p, batch) if comm is None else comm
        held = list(self.comm.ranks)
        self.n_held = h = len(held)
        self.n_c_slots = plan.n_c_slots
        self._routes = [
            _send_route(plan.routes[f"expand_{op}"], plan.local_ids[f"{op}_nz"].shape[1],
                        self.device, batch, held)
            for op in ("a", "b")
        ]
        # one pair list over the stacked tables, without the padding pairs
        rank = np.arange(h, dtype=np.int64)[:, None]
        pc_local = plan.compute["pair_c"][held]
        keep = (pc_local != plan.n_c_slots - 1).ravel()
        pa = (plan.compute["pair_a"][held] + rank * plan.a_table_slots).ravel()[keep]
        pb = (plan.compute["pair_b"][held] + rank * plan.b_table_slots).ravel()[keep]
        pc = (pc_local + rank * plan.n_c_slots).ravel()[keep]
        # one copy of the lists per value set, offset by the held ranks' tables
        m = batch or 1
        slots = [h * n for n in (plan.a_table_slots, plan.b_table_slots, plan.n_c_slots)]
        if m * max(slots) > np.iinfo(np.int32).max:
            raise ValueError(
                f"a batch of {m} puts {m} x {max(slots)} table slots past the "
                f"kernel's int32 indices; split the batch"
            )
        pa, pb, pc = (per_set(x, n, batch) for x, n in zip((pa, pb, pc), slots))
        run_start, run_c = pair_runs(pc)
        self.pair_a, self.pair_b, self.pair_c = (
            _int32(x, self.device) for x in (pa, pb, pc)
        )
        self.run_start = _int32(run_start, self.device)
        self.run_c = _int32(run_c, self.device)
        self.n_c_blocks = m * h * plan.n_c_slots

    def kernel_inputs(self, a_own: torch.Tensor, b_own: torch.Tensor) -> tuple:
        """The arguments of the step's one ``bsr_spgemm_local`` launch."""
        return (
            _expand(self.comm, a_own, self._routes[0], self._lead),
            _expand(self.comm, b_own, self._routes[1], self._lead),
            self.pair_a,
            self.pair_b,
            self.pair_c,
            self.run_start,
            self.run_c,
            self.n_c_blocks,
        )

    def __call__(self, a_own: torch.Tensor, b_own: torch.Tensor) -> torch.Tensor:
        c = bsr_spgemm_local(*self.kernel_inputs(a_own, b_own))
        return c.reshape(*self._lead, self.n_held, self.n_c_slots, self.block, self.block)


def make_monoC_step(
    plan: MonoCPlan, device, block: int = 8, batch: int | None = None, comm=None
) -> MonoCStep:
    """The monoC executor core (``repro``'s ``make_monoC_step``), with the
    held ranks' tables uploaded to ``device`` once."""
    return MonoCStep(plan, block, device, batch, comm)


def monoC_spgemm(
    a_dense: np.ndarray,
    b_dense: np.ndarray,
    plan: MonoCPlan,
    device=None,
    block: int = 8,
) -> torch.Tensor:
    """2D sparsity-dependent monochrome-C SpGEMM (Ex. 5.4).

    ``plan`` must have been built on the b x b block structures of the
    operands (``plan_ir.plan_monoC_from_dense`` does both steps).  Runs on
    the card unless ``device`` names another (``"cpu"`` runs the plain
    version of the kernel).  Returns rank-major C block shards
    (p, C_max + 1, b, b); use ``unpack_monoC_result``.  Thin wrapper over
    the compile-once runtime: same-structure calls hit its cache.
    """
    from repro_torch.distributed.runtime import compile_spgemm, torch_dtype
    from repro_torch.sparse.bsr import to_bsr

    ab = to_bsr(np.asarray(a_dense), block, block)
    bb = to_bsr(np.asarray(b_dense), block, block)
    if len(plan.a_part) != ab.n_blocks or len(plan.b_part) != bb.n_blocks:
        raise ValueError("plan was built for a different block structure")
    exe = compile_spgemm(
        plan,
        ab.block_structure(),
        bb.block_structure(),
        device=device,
        dtype=torch_dtype(np.promote_types(ab.blocks.dtype, bb.blocks.dtype)),
        block=block,
    )
    return exe(ab.blocks, bb.blocks)


def make_monoC_unpack(plan: MonoCPlan, c_structure, shape: tuple[int, int], device):
    """``unpack(c_local) -> dense (shape)`` with its scatter indices
    uploaded once: C block slots go to their block-grid coordinates.  A
    leading set axis on ``c_local`` unpacks every set in the same pass."""
    local_c = plan.local_ids["c_nz"]
    dev, slot = np.nonzero(local_c >= 0)
    gids = local_c[dev, slot]
    crow, ccol = c_structure.coo()
    device = torch.device(device)
    src = torch.as_tensor(dev * plan.n_c_slots + slot, device=device)
    rows = torch.as_tensor(crow[gids], device=device)
    cols = torch.as_tensor(ccol[gids], device=device)

    def unpack(c_local: torch.Tensor) -> torch.Tensor:
        b, lead = c_local.shape[-1], c_local.shape[:-4]
        out = c_local.new_zeros((*lead, shape[0] // b, shape[1] // b, b, b))
        out[..., rows, cols, :, :] = c_local.reshape(*lead, -1, b, b)[..., src, :, :]
        return out.transpose(-3, -2).reshape(*lead, *shape)

    return unpack


def unpack_monoC_result(
    c_local: torch.Tensor,
    plan: MonoCPlan,
    c_structure,
    shape: tuple[int, int],
) -> torch.Tensor:
    """Scatter rank-major C block slots back to a dense tensor on
    ``c_local``'s device.  ``c_structure`` is the block-grid structure of C
    (``inst.c`` of the plan instance); ``shape`` the padded dense shape
    (block-grid * block)."""
    return make_monoC_unpack(plan, c_structure, shape, c_local.device)(c_local)


# ---------------------------------------------------------------------------
# 3D fine-grained (Def. 3.1); monoA and monoB lower to the same plans
# ---------------------------------------------------------------------------
class FineStep:
    """The fine-grained executor core (expand-expand-reduce) for one plan on
    one device.

    ``step(a_own, b_own)`` takes rank-major packed scalar tables of the held
    ranks ((held, N_max)) and returns their rank-major owned-C slot values
    (held, C_max + 1); the trailing slot per rank is the padding sink and
    stays zero.  Local compute is two gathers, a product and ONE
    ``index_add_`` over the held ranks' multiplications into their
    produced-partial-C tables (the i-th held rank's slots offset by i times
    the per-rank table size, the padding pairs dropped); the reduce
    all_to_all then folds foreign partials into each C
    nonzero's owner, and the partials a rank both produced and owns fold
    locally (``prod_to_owned``).  With ``batch=m`` tables and result have a
    leading axis of m value sets, and the gathers, the product and the one
    ``index_add_`` run over per-set copies of the pair lists, set i's slots
    offset by i times one set's table size.
    """

    def __init__(self, plan: FinePlan, device, batch: int | None = None, comm=None):
        p = plan.p
        self.p = p
        self.batch = batch
        self._lead = () if batch is None else (batch,)
        self.comm = make_comm(p, batch) if comm is None else comm
        held = list(self.comm.ranks)
        self.n_held = h = len(held)
        self.n_prod = plan.n_prod_slots
        self.n_c = plan.n_c_slots
        self._routes = [
            _send_route(plan.routes[f"expand_{op}"], plan.local_ids[f"{op}_nz"].shape[1],
                        device, batch, held)
            for op in ("a", "b")
        ]
        self._reduce = _send_route(plan.routes["reduce_c"], self.n_prod, device, batch, held)
        rank = np.arange(h, dtype=np.int64)[:, None]
        pc = plan.compute["pair_c"][held]
        keep = (pc != self.n_prod - 1).ravel()
        pairs = (
            ((plan.compute["pair_a"][held] + rank * plan.a_table_slots).ravel()[keep],
             h * plan.a_table_slots),
            ((plan.compute["pair_b"][held] + rank * plan.b_table_slots).ravel()[keep],
             h * plan.b_table_slots),
            ((pc + rank * self.n_prod).ravel()[keep], h * self.n_prod),
        )
        self.pair_a, self.pair_b, self.pair_c = (
            _flat(per_set(x, n, batch), device) for x, n in pairs
        )
        # arrivals of the reduce: slot [s, d, t] folds into d's owned C slot
        # (read as recv[i, s, t] for the i-th held d, or recv[set, i, s, t]
        # when batched)
        recv_slot = plan.compute["reduce_recv_slot"][:, held]
        s_ids, d_ids, t_ids = np.nonzero(recv_slot >= 0)
        arrivals = (d_ids, s_ids, t_ids)
        if batch is not None:
            sets = np.repeat(np.arange(batch), len(d_ids))
            arrivals = (sets, *(np.tile(x, batch) for x in arrivals))
        self._arrivals = tuple(_flat(x, device) for x in arrivals)
        self._arrival_dst = _flat(
            per_set(d_ids * self.n_c + recv_slot[s_ids, d_ids, t_ids], h * self.n_c, batch),
            device,
        )
        own = plan.compute["prod_to_owned"][held]
        d_ids, r_ids = np.nonzero(own >= 0)
        self._own_src = _flat(per_set(d_ids * self.n_prod + r_ids, h * self.n_prod, batch),
                              device)
        self._own_dst = _flat(per_set(d_ids * self.n_c + own[d_ids, r_ids], h * self.n_c,
                                       batch), device)

    def __call__(self, a_own: torch.Tensor, b_own: torch.Tensor) -> torch.Tensor:
        h, lead, m = self.n_held, self._lead, self.batch or 1
        a_tab = _expand(self.comm, a_own, self._routes[0], lead)
        b_tab = _expand(self.comm, b_own, self._routes[1], lead)
        # local compute: exactly this rank's multiplication vertices
        prods = a_tab[self.pair_a] * b_tab[self.pair_b]
        partial = prods.new_zeros(m * h * self.n_prod).index_add_(0, self.pair_c, prods)
        # reduce phase: ship foreign partials to their C owners
        flat_idx, n_items, T = self._reduce
        recv = self.comm.all_to_all(_take0(partial, flat_idx).reshape(*lead, h, self.p, T),
                                    n_items)
        c = partial.new_zeros(m * h * self.n_c)
        c.index_add_(0, self._arrival_dst, recv[self._arrivals])
        c.index_add_(0, self._own_dst, partial[self._own_src])
        return c.reshape(*lead, h, self.n_c)


def make_fine_step(plan: FinePlan, device, batch: int | None = None, comm=None) -> FineStep:
    """The fine-grained executor core (``repro``'s ``make_fine_step``), with
    the held ranks' tables uploaded to ``device`` once."""
    return FineStep(plan, device, batch, comm)


def fine_spgemm(a, b, plan: FinePlan, device=None) -> torch.Tensor:
    """3D fine-grained SpGEMM (Def. 3.1): expand-expand-reduce.

    ``plan`` is a ``FinePlan`` over the scalar nonzero structures of the
    operands (``plan_ir.plan_fine_from_dense`` builds both).  ``a`` / ``b``
    may each be a dense array, a scipy sparse matrix, or an
    ``(SparseStructure, values)`` pair — sparse callers never densify.
    Returns rank-major owned-C slot values (p, C_max + 1); use
    ``unpack_fine_result``.  Runs on the card unless ``device`` names
    another; same-structure calls hit the runtime's cache.
    """
    from repro_torch.distributed.runtime import compile_spgemm, torch_dtype
    from repro_torch.sparse.structure import structure_and_values

    a_s, a_vals = structure_and_values(a)
    b_s, b_vals = structure_and_values(b)
    if a_s.nnz != len(plan.a_part) or b_s.nnz != len(plan.b_part):
        raise ValueError("plan was built for a different nonzero structure")
    exe = compile_spgemm(
        plan,
        a_s,
        b_s,
        device=device,
        dtype=torch_dtype(np.promote_types(a_vals.dtype, b_vals.dtype)),
    )
    return exe(a_vals, b_vals)


def make_fine_unpack(plan: FinePlan, c_structure, shape: tuple[int, int], device):
    """``unpack(c_local) -> dense (shape)`` with its scatter indices
    uploaded once: owned C slots go to their coordinates.  A leading set
    axis on ``c_local`` unpacks every set in the same pass."""
    local_c = plan.local_ids["c_nz"]
    dev, slot = np.nonzero(local_c >= 0)
    gids = local_c[dev, slot]
    crow, ccol = c_structure.coo()
    src = _flat(dev * plan.n_c_slots + slot, device)
    rows, cols = _flat(crow[gids], device), _flat(ccol[gids], device)

    def unpack(c_local: torch.Tensor) -> torch.Tensor:
        lead = c_local.shape[:-2]
        out = c_local.new_zeros((*lead, *shape))
        out[..., rows, cols] = c_local.reshape(*lead, -1)[..., src]
        return out

    return unpack


def unpack_fine_result(
    c_local: torch.Tensor,
    plan: FinePlan,
    c_structure,
    shape: tuple[int, int],
) -> torch.Tensor:
    """Scatter rank-major owned-C slot values back to a dense tensor on
    ``c_local``'s device."""
    return make_fine_unpack(plan, c_structure, shape, c_local.device)(c_local)
