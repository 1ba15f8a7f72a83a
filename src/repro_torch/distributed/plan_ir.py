"""Plan IR: one model-agnostic description of a lowered SpGEMM execution.

A copy of ``repro.distributed.plan_ir`` (every model's builders and the
generic volume plan), plus ``plan_from_reference``, which rebuilds a plan
lowered elsewhere, and ``moved_items``, what the executors' collectives move.

The paper's central claim is that a hypergraph partition *is* an SpGEMM
algorithm: the cut prescribes exactly the data movement.  ``ExecutionPlan``
is that prescription made concrete — the inspector output every executor in
``spgemm_exec`` consumes, whichever of the seven models produced it:

- **ownership**: global-id -> part maps, one per object family the model
  distributes ("a_nz", "b_nz", "c_nz", ...).
- **local_ids**: per-rank padded id lists (p, N_max) with -1 padding —
  the rank-major inverse of each ownership map.
- **routes**: padded all_to_all routing tables (``Route``), one per expand
  phase.  A route realizes the cut nets of one operand: item t shipped from
  s to d is exactly one (cut net, touched part) pair of the partition, plus
  padding to the per-pair maximum so every rank's buffer has one shape.
- **compute**: per-rank local work lists (the (pair_a, pair_b, pair_c)
  block multiplication lists the BSR kernel streams through).
- **stats**: scalar accounting that is not a routing table (fold volumes,
  pair counts).

Ideal (connectivity-metric) vs padded volume is tracked per route so the
executor's overhead can be set against the combinatorial cost the
partitioner minimized.  Plan construction is fully vectorized (``np.unique``
on encoded (item, destination) keys, stable argsorts, bincount offsets).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.spgemm_models import SpGEMMInstance


# ---------------------------------------------------------------------------
# IR containers
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Route:
    """One padded all_to_all expand phase.

    ``send_idx[s, d, t]`` is the *local* slot (into the sender's owned-item
    list) of the t-th item device s ships to device d; ``recv_key[s, d, t]``
    is that item's *global* id; -1 marks padding in both.  ``word_size`` is
    the payload words per item (a B row of J words, a b x b block, ...), so
    route volumes compose into word counts.
    """

    payload: str  # which operand moves: "A" | "B" | "C"
    send_idx: np.ndarray  # (p, p, T) int64, -1 padding
    recv_key: np.ndarray  # (p, p, T) int64 global item ids, -1 padding
    items_ideal: int  # (cut net, touched part) pairs = connectivity volume
    items_padded: int  # p * p * T actually shipped
    word_size: int = 1
    # per-item word accounting: when items carry different payload sizes
    # (e.g. a B row of nnz(row k) useful words), the cost-weighted ideal
    # volume and the static-slot padded volume (every slot sized to the
    # largest shipped item) are stored here; None means uniform word_size.
    words_ideal_override: int | None = None
    words_padded_override: int | None = None

    @property
    def T(self) -> int:
        return self.send_idx.shape[-1]

    @property
    def words_ideal(self) -> int:
        if self.words_ideal_override is not None:
            return int(self.words_ideal_override)
        return int(self.items_ideal * self.word_size)

    @property
    def words_padded(self) -> int:
        if self.words_padded_override is not None:
            return int(self.words_padded_override)
        return int(self.items_padded * self.word_size)

    @property
    def padding_fraction(self) -> float:
        return (self.items_padded - self.items_ideal) / max(self.items_padded, 1)


@dataclasses.dataclass
class ExecutionPlan:
    """Model-agnostic inspector output: ownership + routing + local work."""

    model: str
    p: int
    ownership: dict[str, np.ndarray]
    local_ids: dict[str, np.ndarray]
    routes: dict[str, Route] = dataclasses.field(default_factory=dict)
    compute: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    stats: dict = dataclasses.field(default_factory=dict)

    @property
    def comm_words_ideal(self) -> int:
        route_words = sum(r.words_ideal for r in self.routes.values())
        return int(route_words + self.stats.get("fold_words_ideal", 0))

    @property
    def comm_words_padded(self) -> int:
        route_words = sum(r.words_padded for r in self.routes.values())
        return int(route_words + self.stats.get("fold_words_padded", 0))

    @property
    def padding_fraction(self) -> float:
        padded = self.comm_words_padded
        return (padded - self.comm_words_ideal) / max(padded, 1)


def measured_route_words(
    plan: "ExecutionPlan", item_words: dict[str, np.ndarray] | None = None
) -> int:
    """Words the plan's routing tables actually ship (valid slots only).

    Counted from the materialized ``recv_key`` tables — the executor moves
    exactly these entries (plus padding) — NOT from the hypergraph's lambda
    counting, so equality with ``evaluate().connectivity`` is a real check
    that the cut and the schedule describe the same traffic.  ``item_words``
    optionally maps a route name to per-global-item useful word counts
    (e.g. nnz per shipped B row); routes not named count ``word_size`` per
    item.  Fold-phase words tracked only in ``stats`` (the outer plan's
    psum_scatter) are added as-is since that phase has no routing table.
    """
    words = 0
    for name, r in plan.routes.items():
        keys = r.recv_key[r.recv_key >= 0]
        if item_words is not None and name in item_words:
            words += int(item_words[name][keys].sum())
        else:
            words += len(keys) * r.word_size
    return int(words + plan.stats.get("fold_words_ideal", 0))


def route_messages(plan: "ExecutionPlan") -> int:
    """Point-to-point messages the plan schedules: the number of non-empty
    ``(src, dst)`` cells across all routing tables (one padded all_to_all
    lane per pair, however many items it carries), plus fold-phase messages
    tracked only in ``stats`` (the outer plan's psum_scatter has no table —
    ``build_outer_plan`` records ``p * (p - 1)`` there).  The alpha term of
    the alpha-beta cost model, next to ``measured_route_words``'s beta."""
    msgs = 0
    for r in plan.routes.values():
        msgs += int((r.recv_key >= 0).any(axis=2).sum())
    return int(msgs + plan.stats.get("fold_messages", 0))


# ---------------------------------------------------------------------------
# Vectorized construction primitives
# ---------------------------------------------------------------------------
def padded_id_lists(part: np.ndarray, p: int) -> tuple[np.ndarray, np.ndarray]:
    """Invert an ownership map into device-major padded id lists.

    Returns ``(local_ids, local_of)``: ``local_ids[d]`` lists the global ids
    owned by part d in ascending order (-1 padded to the per-part maximum,
    floor 1), and ``local_of[g]`` is g's position within its owner's list.
    """
    part = np.asarray(part, dtype=np.int64)
    n = len(part)
    order = np.argsort(part, kind="stable")  # groups by part, ids ascending
    counts = np.bincount(part, minlength=p) if n else np.zeros(p, dtype=np.int64)
    n_max = max(int(counts.max(initial=0)), 1)
    starts = np.cumsum(counts) - counts
    rank = np.arange(n, dtype=np.int64) - np.repeat(starts, counts)
    local_ids = np.full((p, n_max), -1, dtype=np.int64)
    local_ids[part[order], rank] = order
    local_of = np.empty(n, dtype=np.int64)
    local_of[order] = rank
    return local_ids, local_of


def build_route(
    src: np.ndarray,
    dst: np.ndarray,
    item: np.ndarray,
    local_of: np.ndarray,
    p: int,
    payload: str,
    word_size: int = 1,
    send_slot: np.ndarray | None = None,
    item_words: np.ndarray | None = None,
) -> Route:
    """Lower a transfer list to a padded all_to_all routing table.

    ``(src[t], dst[t], item[t])`` enumerates every (cut net, touched part)
    pair — one shipped item per entry, ``dst != src`` already enforced.
    Entries must arrive sorted by item id; the stable per-(src, dst) grouping
    then keeps items ascending inside each cell, matching the loop-based
    reference builder byte for byte.

    ``send_slot`` overrides the sender-local slot per transfer when an item's
    slot depends on the sender (e.g. partial-C tables, where one C nonzero is
    produced on several devices); ``item_words`` gives per-item useful word
    counts for cost-weighted volume accounting (non-uniform net costs).
    """
    n = len(item)
    order = np.argsort(src * p + dst, kind="stable")
    s_o, d_o, it_o = src[order], dst[order], item[order]
    key = s_o * p + d_o
    _, counts = np.unique(key, return_counts=True)
    T = max(int(counts.max(initial=0)), 1)
    starts = np.cumsum(counts) - counts
    slot = np.arange(n, dtype=np.int64) - np.repeat(starts, counts)
    send_idx = np.full((p, p, T), -1, dtype=np.int64)
    recv_key = np.full((p, p, T), -1, dtype=np.int64)
    send_idx[s_o, d_o, slot] = send_slot[order] if send_slot is not None else local_of[it_o]
    recv_key[s_o, d_o, slot] = it_o
    words_ideal = words_padded = None
    if item_words is not None:
        words_ideal = int(item_words[item].sum())
        # an executor's all_to_all slots are statically sized to the largest
        # shipped item, so the padded wire volume scales with that maximum
        words_padded = p * p * T * int(item_words[item].max(initial=0)) if n else 0
    return Route(
        payload=payload,
        send_idx=send_idx,
        recv_key=recv_key,
        items_ideal=n,
        items_padded=p * p * T if n else 0,
        word_size=word_size,
        words_ideal_override=words_ideal,
        words_padded_override=words_padded,
    )


def _expand_transfers(
    item_of_need: np.ndarray,
    part_of_need: np.ndarray,
    item_owner: np.ndarray,
    p: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deduplicate (item, consuming part) incidences into transfers.

    ``item_of_need[t]`` needs to be visible on ``part_of_need[t]`` (one entry
    per pin of the item's net); returns the unique (src, dst, item) transfer
    triples with dst != owner, sorted by item — the exact cut-net traffic
    sum_n c(n) * (lambda(n) - 1) of the partition.
    """
    pairs = np.unique(item_of_need * p + part_of_need)  # sorted by (item, part)
    items, dsts = pairs // p, pairs % p
    srcs = item_owner[items]
    keep = dsts != srcs
    return srcs[keep], dsts[keep], items[keep]


def derive_owner_from_pins(
    item_of_need: np.ndarray,
    part_of_need: np.ndarray,
    n_items: int,
    p: int,
) -> np.ndarray:
    """Assign each item to the lowest-numbered part that needs it.

    This is the paper's omitted-V^nz reading of the connectivity metric: a
    nonzero resides on one of the parts whose computation touches it, so a
    cut net of connectivity lambda costs exactly lambda - 1 transfers.  With
    ownership derived this way, every route's ``items_ideal`` equals the
    hypergraph connectivity contribution of its nets — predicted == planned.
    Items no computation touches (dead nonzeros) fall back to round-robin;
    they never generate traffic either way.
    """
    pairs = np.unique(item_of_need * p + part_of_need)  # sorted (item, part)
    items, parts = pairs // p, pairs % p
    first_item, first_pos = np.unique(items, return_index=True)
    owner = np.arange(n_items, dtype=np.int64) % p
    owner[first_item] = parts[first_pos]  # min part per item: pairs are sorted
    return owner


# ---------------------------------------------------------------------------
# 1D row-wise (Ex. 5.1)
# ---------------------------------------------------------------------------
class RowwisePlan(ExecutionPlan):
    """Row-wise plan: device d owns A/C row set R_d and B row set S_d; one
    expand route ships each cut B-net (B row) to every part whose A-columns
    touch it.  Legacy field names are accessors into the IR."""

    @property
    def row_part(self) -> np.ndarray:
        return self.ownership["a_row"]

    @property
    def b_part(self) -> np.ndarray:
        return self.ownership["b_row"]

    @property
    def local_rows(self) -> np.ndarray:
        return self.local_ids["a_row"]

    @property
    def local_b_rows(self) -> np.ndarray:
        return self.local_ids["b_row"]

    @property
    def send_idx(self) -> np.ndarray:
        return self.routes["expand"].send_idx

    @property
    def recv_key(self) -> np.ndarray:
        return self.routes["expand"].recv_key


def build_rowwise_plan(
    inst: SpGEMMInstance,
    row_part: np.ndarray,
    p: int,
    b_part: np.ndarray | None = None,
) -> RowwisePlan:
    """Vectorized inspector for the row-wise model (CSC index arithmetic;
    the reference keeps a loop-based executable specification)."""
    I, K, J = inst.shape
    row_part = np.asarray(row_part, dtype=np.int64)
    if b_part is None:
        # default B distribution: round-robin rows (paper Sec. 6: V^nz omitted)
        b_part = np.arange(K, dtype=np.int64) % p
    else:
        b_part = np.asarray(b_part, dtype=np.int64)

    # B row k is needed wherever A column k has a nonzero: one incidence per
    # A nonzero, deduplicated to (k, part) pairs
    acsc = inst.a_csc
    ks = np.repeat(np.arange(K, dtype=np.int64), np.diff(acsc.indptr))
    src, dst, items = _expand_transfers(
        ks, row_part[acsc.indices.astype(np.int64)], b_part, p
    )
    local_b_rows, local_of_b = padded_id_lists(b_part, p)
    route = build_route(src, dst, items, local_of_b, p, payload="B")
    local_rows, _ = padded_id_lists(row_part, p)
    return RowwisePlan(
        model="rowwise",
        p=p,
        ownership={"a_row": row_part, "b_row": b_part},
        local_ids={"a_row": local_rows, "b_row": local_b_rows},
        routes={"expand": route},
    )


# ---------------------------------------------------------------------------
# 1D outer-product (Ex. 5.2)
# ---------------------------------------------------------------------------
class OuterPlan(ExecutionPlan):
    """Outer-product plan: device d owns A-column/B-row set K_d; the fold
    phase (psum_scatter over C row blocks) carries the C-net volume."""

    @property
    def k_part(self) -> np.ndarray:
        return self.ownership["k"]

    @property
    def c_part(self) -> np.ndarray:
        return self.ownership["c_row"]

    @property
    def local_ks(self) -> np.ndarray:
        return self.local_ids["k"]


def build_outer_plan(
    inst: SpGEMMInstance,
    k_part: np.ndarray,
    p: int,
    c_part: np.ndarray | None = None,
) -> OuterPlan:
    I, K, J = inst.shape
    k_part = np.asarray(k_part, dtype=np.int64)
    if c_part is None:
        c_part = np.arange(I, dtype=np.int64) % p
    else:
        c_part = np.asarray(c_part, dtype=np.int64)
    local_ks, _ = padded_id_lists(k_part, p)
    # ideal fold volume: per C nonzero, (#distinct contributing k-parts - 1)
    cpos = inst.mult_i * J + inst.mult_j
    pair = np.unique(cpos * p + k_part[inst.mult_k])
    lam = np.bincount(pair // p)
    ideal = int(np.maximum(lam[lam > 0] - 1, 0).sum())
    # realized fold: the executor's psum_scatter reduces dense padded C row
    # blocks regardless of sparsity — every device ships (p-1)/p of I_pad * J
    I_pad = (I + p - 1) // p * p
    padded = I_pad * (p - 1) * J if p > 1 else 0
    return OuterPlan(
        model="outer",
        p=p,
        ownership={"k": k_part, "c_row": c_part},
        local_ids={"k": local_ks},
        stats={
            "fold_words_ideal": ideal,
            "fold_words_padded": padded,
            # the psum_scatter is all-pairs: every device sends one C-row
            # chunk to each of the other p - 1
            "fold_messages": p * (p - 1) if p > 1 else 0,
        },
    )


# ---------------------------------------------------------------------------
# 2D monochrome-C (Ex. 5.4)
# ---------------------------------------------------------------------------
class MonoCPlan(ExecutionPlan):
    """Monochrome-C plan over a (block) SpGEMM instance.

    Vertices of the monoC hypergraph are C nonzeros; a partition of them is
    an ownership map for C.  A and B nonzeros are distributed by their own
    maps (default round-robin, matching the omitted-V^nz convention), and
    the cut A-nets / B-nets lower to two expand routes.  Per-device pair
    lists drive the BSR kernel over local slot tables laid out as
    ``[owned (N_max) | received (p * T) | zero pad (1)]``.
    """

    @property
    def c_part(self) -> np.ndarray:
        return self.ownership["c_nz"]

    @property
    def a_part(self) -> np.ndarray:
        return self.ownership["a_nz"]

    @property
    def b_part(self) -> np.ndarray:
        return self.ownership["b_nz"]

    # slot-table layout constants the executor mirrors
    @property
    def a_table_slots(self) -> int:
        return self.local_ids["a_nz"].shape[1] + self.p * self.routes["expand_a"].T + 1

    @property
    def b_table_slots(self) -> int:
        return self.local_ids["b_nz"].shape[1] + self.p * self.routes["expand_b"].T + 1

    @property
    def n_c_slots(self) -> int:
        """Local C slots incl. the trailing garbage slot padding pairs hit."""
        return self.local_ids["c_nz"].shape[1] + 1


def _table_slots(
    part: np.ndarray,
    local_of: np.ndarray,
    route: Route,
    n_items: int,
    p: int,
) -> np.ndarray:
    """(p, n_items) map: global item id -> per-device slot in the
    ``[owned | received | zero]`` table; -1 where the device never sees it."""
    n_owned = 0 if n_items == 0 else int(local_of.max(initial=-1)) + 1
    # owned slots span [0, N_max); N_max from the padded list width
    slots = np.full((p, n_items), -1, dtype=np.int64)
    slots[part, np.arange(n_items, dtype=np.int64)] = local_of
    T = route.T
    s_ids, d_ids, t_ids = np.nonzero(route.recv_key >= 0)
    keys = route.recv_key[s_ids, d_ids, t_ids]
    slots[d_ids, keys] = n_owned + s_ids * T + t_ids
    return slots


def build_monoC_plan(
    inst: SpGEMMInstance,
    c_part: np.ndarray,
    p: int,
    a_part: np.ndarray | None = None,
    b_part: np.ndarray | None = None,
    word_size: int = 1,
) -> MonoCPlan:
    """Lower a monoC partition to routes + per-device BSR pair lists.

    ``inst`` may be a scalar instance or the block structure of a tiled one
    (tiling is a vertex coarsening — the plan is the same object either
    way); ``word_size`` records the payload words per shipped nonzero
    (b*b for b x b blocks) for volume accounting.
    """
    nA, nB, nC = inst.a.nnz, inst.b.nnz, inst.c.nnz
    c_part = np.asarray(c_part, dtype=np.int64)
    if a_part is None:
        a_part = np.arange(nA, dtype=np.int64) % p
    else:
        a_part = np.asarray(a_part, dtype=np.int64)
    if b_part is None:
        b_part = np.arange(nB, dtype=np.int64) % p
    else:
        b_part = np.asarray(b_part, dtype=np.int64)

    a_pos, b_pos, c_pos = inst.mult_a_pos, inst.mult_b_pos, inst.mult_c_pos
    mult_dev = c_part[c_pos]

    # expand routes: A nonzero ik is needed on every part owning a pin of
    # net n^A_ik (a multiplication it feeds); same for B — Ex. 5.4's nets
    local_a, local_of_a = padded_id_lists(a_part, p)
    src, dst, items = _expand_transfers(a_pos, mult_dev, a_part, p)
    route_a = build_route(src, dst, items, local_of_a, p, "A", word_size)
    local_b, local_of_b = padded_id_lists(b_part, p)
    src, dst, items = _expand_transfers(b_pos, mult_dev, b_part, p)
    route_b = build_route(src, dst, items, local_of_b, p, "B", word_size)
    local_c, local_of_c = padded_id_lists(c_part, p)

    # per-device pair lists in table slots (vectorized: one lexsort)
    a_slots = _table_slots(a_part, local_of_a, route_a, nA, p)
    b_slots = _table_slots(b_part, local_of_b, route_b, nB, p)
    pa = a_slots[mult_dev, a_pos]
    pb = b_slots[mult_dev, b_pos]
    pc = local_of_c[c_pos]
    assert (pa >= 0).all() and (pb >= 0).all(), "routing missed a needed nonzero"
    # group by device, then C slot ascending (kernel accumulates runs), then
    # operand slots for determinism
    order = np.lexsort((pb, pa, pc, mult_dev))
    pa, pb, pc, dev = pa[order], pb[order], pc[order], mult_dev[order]
    counts = np.bincount(dev, minlength=p)
    P_max = max(int(counts.max(initial=0)), 1)
    starts = np.cumsum(counts) - counts
    rank = np.arange(len(dev), dtype=np.int64) - np.repeat(starts, counts)
    # padding pairs hit the all-zero operand slots and the garbage C slot
    A_max, B_max, C_max = local_a.shape[1], local_b.shape[1], local_c.shape[1]
    pair_a = np.full((p, P_max), A_max + p * route_a.T, dtype=np.int64)
    pair_b = np.full((p, P_max), B_max + p * route_b.T, dtype=np.int64)
    pair_c = np.full((p, P_max), C_max, dtype=np.int64)
    pair_a[dev, rank] = pa
    pair_b[dev, rank] = pb
    pair_c[dev, rank] = pc

    return MonoCPlan(
        model="monoC",
        p=p,
        ownership={"c_nz": c_part, "a_nz": a_part, "b_nz": b_part},
        local_ids={"c_nz": local_c, "a_nz": local_a, "b_nz": local_b},
        routes={"expand_a": route_a, "expand_b": route_b},
        compute={"pair_a": pair_a, "pair_b": pair_b, "pair_c": pair_c},
        stats={"n_pairs": int(len(dev)), "pairs_padded": int(p * P_max)},
    )


def plan_monoC_from_dense(
    a_dense: np.ndarray,
    b_dense: np.ndarray,
    block: int,
    p: int,
    eps: float = 0.10,
    seed: int = 0,
) -> tuple[MonoCPlan, SpGEMMInstance]:
    """Tile, model, partition, plan — the full monoC inspector pipeline.

    Tiling into b x b blocks is a vertex coarsening of the fine-grained
    hypergraph (DESIGN.md), so the monoC model of the *block* instance is
    partitioned and the resulting plan drives the BSR executor directly.
    Returns (plan, block instance) — the instance is also what
    ``unpack_monoC_result`` needs (``inst.c`` and the padded shapes).
    """
    from repro_torch.core.partition import partition
    from repro_torch.core.spgemm_models import build_model
    from repro_torch.sparse.bsr import to_bsr

    ab = to_bsr(np.asarray(a_dense), block, block)
    bb = to_bsr(np.asarray(b_dense), block, block)
    inst = SpGEMMInstance(ab.block_structure(), bb.block_structure(), name="monoC")
    hg = build_model(inst, "monoC")
    res = partition(hg, p, eps=eps, seed=seed)
    plan = build_monoC_plan(inst, res.parts, p, word_size=block * block)
    return plan, inst


# ---------------------------------------------------------------------------
# 3D fine-grained (Def. 3.1)
# ---------------------------------------------------------------------------
class FinePlan(ExecutionPlan):
    """Fine-grained plan: an arbitrary flop-level partition made executable.

    Vertices of the fine hypergraph are scalar multiplications a_ik * b_kj;
    the partition assigns each to a device.  Ownership maps distribute the
    A, B and C nonzeros (derived from the pins when not given, so a cut net
    of connectivity lambda costs exactly lambda - 1 transfers — predicted
    connectivity == planned words).  Three routes realize the three net
    families: ``expand_a`` / ``expand_b`` ship cut A-/B-nets before local
    compute, ``reduce_c`` ships partial C contributions to each C nonzero's
    owner afterwards — the paper's expand-expand-reduce schedule.

    Per-device state the executor mirrors:

    - operand slot tables ``[owned | received | zero]`` (as monoC);
    - a *produced-C* table: slot r on device d accumulates d's partial sum
      for the r-th distinct C nonzero d's multiplications contribute to
      (``local_ids["c_prod"]``), plus a trailing garbage slot for padding;
    - ``compute["pair_*"]``: padded (p, P_max) multiplication lists in slot
      coordinates — pair_a/pair_b index the operand tables, pair_c the
      produced table;
    - ``compute["reduce_recv_slot"]``: (p, p, T_r) owned-C slot each arriving
      reduce item folds into (-1 padding);
    - ``compute["prod_to_owned"]``: (p, R_max) owned-C slot of each produced
      slot when the producer already owns that C nonzero (-1 otherwise).
    """

    @property
    def mult_part(self) -> np.ndarray:
        return self.ownership["mult"]

    @property
    def a_part(self) -> np.ndarray:
        return self.ownership["a_nz"]

    @property
    def b_part(self) -> np.ndarray:
        return self.ownership["b_nz"]

    @property
    def c_part(self) -> np.ndarray:
        return self.ownership["c_nz"]

    @property
    def a_table_slots(self) -> int:
        return self.local_ids["a_nz"].shape[1] + self.p * self.routes["expand_a"].T + 1

    @property
    def b_table_slots(self) -> int:
        return self.local_ids["b_nz"].shape[1] + self.p * self.routes["expand_b"].T + 1

    @property
    def n_prod_slots(self) -> int:
        """Produced-C slots incl. the trailing garbage slot padding pairs hit."""
        return self.local_ids["c_prod"].shape[1] + 1

    @property
    def n_c_slots(self) -> int:
        """Owned-C slots incl. the trailing garbage slot padded arrivals hit."""
        return self.local_ids["c_nz"].shape[1] + 1


def build_fine_plan(
    inst: SpGEMMInstance,
    mult_part: np.ndarray,
    p: int,
    a_part: np.ndarray | None = None,
    b_part: np.ndarray | None = None,
    c_part: np.ndarray | None = None,
    word_size: int = 1,
) -> FinePlan:
    """Lower a fine-grained (flop-level) partition to an executable plan.

    ``mult_part`` is either a partition of the M multiplication vertices
    (the include_nz=False fine hypergraph) or of the full include_nz vertex
    set — in the latter case the nonzero-vertex assignments become the
    ownership maps.  Ownership not provided either way is derived from the
    pins (``derive_owner_from_pins``), which makes ``comm_words_ideal``
    equal the fine hypergraph's connectivity cost exactly.
    """
    M = inst.n_mult
    nA, nB, nC = inst.a.nnz, inst.b.nnz, inst.c.nnz
    mult_part = np.asarray(mult_part, dtype=np.int64)
    if len(mult_part) == M + nA + nB + nC and nA + nB + nC:
        if a_part is None:
            a_part = mult_part[M : M + nA]
        if b_part is None:
            b_part = mult_part[M + nA : M + nA + nB]
        if c_part is None:
            c_part = mult_part[M + nA + nB :]
        mult_part = mult_part[:M]
    elif len(mult_part) != M:
        raise ValueError(
            f"mult_part has {len(mult_part)} entries; expected {M} "
            f"(multiplications) or {M + nA + nB + nC} (include_nz vertices)"
        )
    mult_dev = mult_part
    a_pos, b_pos, c_pos = inst.mult_a_pos, inst.mult_b_pos, inst.mult_c_pos
    if a_part is None:
        a_part = derive_owner_from_pins(a_pos, mult_dev, nA, p)
    else:
        a_part = np.asarray(a_part, dtype=np.int64)
    if b_part is None:
        b_part = derive_owner_from_pins(b_pos, mult_dev, nB, p)
    else:
        b_part = np.asarray(b_part, dtype=np.int64)
    if c_part is None:
        c_part = derive_owner_from_pins(c_pos, mult_dev, nC, p)
    else:
        c_part = np.asarray(c_part, dtype=np.int64)

    # expand routes: exactly the cut A-/B-net traffic of the fine partition
    local_a, local_of_a = padded_id_lists(a_part, p)
    src, dst, items = _expand_transfers(a_pos, mult_dev, a_part, p)
    route_a = build_route(src, dst, items, local_of_a, p, "A", word_size)
    local_b, local_of_b = padded_id_lists(b_part, p)
    src, dst, items = _expand_transfers(b_pos, mult_dev, b_part, p)
    route_b = build_route(src, dst, items, local_of_b, p, "B", word_size)
    local_c, local_of_c = padded_id_lists(c_part, p)

    # produced-C table: the distinct C nonzeros each device contributes to,
    # device-major with ascending C ids (one partial-sum slot per entry)
    prod_pairs = np.unique(mult_dev * max(nC, 1) + c_pos)
    prod_dev, prod_c = prod_pairs // max(nC, 1), prod_pairs % max(nC, 1)
    prod_counts = np.bincount(prod_dev, minlength=p)
    R_max = max(int(prod_counts.max(initial=0)), 1)
    starts = np.cumsum(prod_counts) - prod_counts
    rank = np.arange(len(prod_dev), dtype=np.int64) - np.repeat(starts, prod_counts)
    prod_ids = np.full((p, R_max), -1, dtype=np.int64)
    prod_ids[prod_dev, rank] = prod_c
    prod_slot = np.full((p, nC), -1, dtype=np.int64)
    prod_slot[prod_dev, prod_c] = rank

    # per-device multiplication lists in slot coordinates (one lexsort)
    a_slots = _table_slots(a_part, local_of_a, route_a, nA, p)
    b_slots = _table_slots(b_part, local_of_b, route_b, nB, p)
    pa = a_slots[mult_dev, a_pos]
    pb = b_slots[mult_dev, b_pos]
    pc = prod_slot[mult_dev, c_pos]
    assert (pa >= 0).all() and (pb >= 0).all() and (pc >= 0).all(), (
        "routing missed a needed nonzero"
    )
    order = np.lexsort((pb, pa, pc, mult_dev))
    pa, pb, pc, dev = pa[order], pb[order], pc[order], mult_dev[order]
    counts = np.bincount(dev, minlength=p)
    P_max = max(int(counts.max(initial=0)), 1)
    starts = np.cumsum(counts) - counts
    rank = np.arange(len(dev), dtype=np.int64) - np.repeat(starts, counts)
    A_max, B_max = local_a.shape[1], local_b.shape[1]
    pair_a = np.full((p, P_max), A_max + p * route_a.T, dtype=np.int64)
    pair_b = np.full((p, P_max), B_max + p * route_b.T, dtype=np.int64)
    pair_c = np.full((p, P_max), R_max, dtype=np.int64)
    pair_a[dev, rank] = pa
    pair_b[dev, rank] = pb
    pair_c[dev, rank] = pc

    # reduce route: every (C net, producing part) pair with a foreign owner —
    # the cut C-net traffic.  Sender slots index the produced-C table.
    red_pairs = np.unique(c_pos * p + mult_dev)  # item-major (c, part)
    r_item, r_src = red_pairs // p, red_pairs % p
    r_dst = c_part[r_item]
    keep = r_src != r_dst
    route_r = build_route(
        r_src[keep],
        r_dst[keep],
        r_item[keep],
        local_of_c,
        p,
        "C",
        word_size,
        send_slot=prod_slot[r_src[keep], r_item[keep]],
    )
    recv_slot = np.where(
        route_r.recv_key >= 0, local_of_c[np.maximum(route_r.recv_key, 0)], -1
    )
    # produced slots the device itself owns fold straight into owned C slots
    prod_owned = np.full((p, R_max), -1, dtype=np.int64)
    d_ids, s_ids = np.nonzero(prod_ids >= 0)
    gids = prod_ids[d_ids, s_ids]
    own = c_part[gids] == d_ids
    prod_owned[d_ids[own], s_ids[own]] = local_of_c[gids[own]]

    return FinePlan(
        model="fine",
        p=p,
        ownership={"mult": mult_dev, "a_nz": a_part, "b_nz": b_part, "c_nz": c_part},
        local_ids={"a_nz": local_a, "b_nz": local_b, "c_nz": local_c, "c_prod": prod_ids},
        routes={"expand_a": route_a, "expand_b": route_b, "reduce_c": route_r},
        compute={
            "pair_a": pair_a,
            "pair_b": pair_b,
            "pair_c": pair_c,
            "reduce_recv_slot": recv_slot,
            "prod_to_owned": prod_owned,
        },
        stats={"n_mult": int(M), "pairs_padded": int(p * P_max)},
    )


def plan_fine_from_dense(
    a_dense,
    b_dense,
    p: int,
    eps: float = 0.10,
    seed: int = 0,
    include_nz: bool = False,
) -> tuple[FinePlan, SpGEMMInstance]:
    """Model, partition, plan — the full fine-grained inspector pipeline.

    Builds the fine hypergraph of the scalar nonzero structures, partitions
    its multiplication vertices, and lowers the result to a ``FinePlan``.
    With ``include_nz`` the partitioner also places the nonzero vertices and
    those placements become the plan's ownership maps.

    The operands may each be a dense array, a scipy sparse matrix, or a
    ``SparseStructure`` — callers that already hold sparse structures never
    round-trip through dense.
    """
    from repro_torch.core.partition import partition
    from repro_torch.core.spgemm_models import build_model
    from repro_torch.sparse.structure import as_structure

    a_s = as_structure(a_dense)
    b_s = as_structure(b_dense)
    inst = SpGEMMInstance(a_s, b_s, name="fine")
    hg = build_model(inst, "fine", include_nz=include_nz)
    res = partition(hg, p, eps=eps, seed=seed)
    plan = build_fine_plan(inst, res.parts, p)
    return plan, inst


# ---------------------------------------------------------------------------
# Generic predicted-volume plan (any model)
# ---------------------------------------------------------------------------
def build_volume_plan(hg, parts: np.ndarray, p: int) -> ExecutionPlan:
    """Lower ANY model hypergraph + partition to net-granularity routes.

    One route per net family (A-expand, B-expand, C-reduce), each shipping a
    cut net from a pin-derived owner to every other touched part, weighted by
    the net's cost.  ``comm_words_ideal`` therefore equals
    ``comm.evaluate(hg, parts, p).connectivity`` — computed here by an
    independent code path (transfer enumeration vs lambda counting), which is
    what the predicted-vs-planned property test pins for all seven models.
    Models with real executors refine this to item-granularity plans; this
    one exists so every model's predicted volume has an IR representation.
    """
    parts = np.asarray(parts, dtype=np.int64)
    pin_parts = parts[hg.net_pins]
    net_ids = np.repeat(np.arange(hg.n_nets, dtype=np.int64), hg.net_sizes())
    owner = derive_owner_from_pins(net_ids, pin_parts, hg.n_nets, p)
    kinds = (
        hg.net_kind
        if hg.net_kind is not None
        else np.zeros(hg.n_nets, dtype=np.int8)
    )
    ident = np.arange(hg.n_nets, dtype=np.int64)
    routes = {}
    for kind, name, payload in (
        (0, "expand", "N"),
        (1, "expand_a", "A"),
        (2, "expand_b", "B"),
        (3, "reduce_c", "C"),
    ):
        sel = kinds[net_ids] == kind
        if not sel.any():
            continue
        src, dst, items = _expand_transfers(net_ids[sel], pin_parts[sel], owner, p)
        routes[name] = build_route(
            src, dst, items, ident, p, payload, item_words=hg.net_cost
        )
    return ExecutionPlan(
        model="volume",
        p=p,
        ownership={"net": owner},
        local_ids={},
        routes=routes,
    )


# ---------------------------------------------------------------------------
# plans lowered elsewhere
# ---------------------------------------------------------------------------
def plan_from_reference(obj) -> ExecutionPlan:
    """Rebuild a plan from any object with the ``ExecutionPlan`` fields.

    ``obj`` needs ``model``, ``p``, ``ownership``, ``local_ids``, ``routes``
    (each route with ``payload``, ``send_idx``, ``recv_key``,
    ``items_ideal``, ``items_padded``, ``word_size`` and the two
    ``words_*_override`` fields), ``compute`` and ``stats``.  Only numpy
    arrays and ints are read, so a plan lowered by another implementation of
    this IR hands the *same* plan to this package's executors.  Every array
    is copied, and the plan comes back as its model's class: ``RowwisePlan``
    for rowwise and columnwise, ``OuterPlan`` for outer, ``FinePlan`` for
    fine, monoA and monoB, ``MonoCPlan`` for monoC, ``SummaPlan`` for
    summa2d.
    """
    from repro_torch.distributed.summa import SummaPlan


    def arrays(group) -> dict[str, np.ndarray]:
        return {k: np.array(v, dtype=np.int64) for k, v in group.items()}

    def opt_int(x):
        return None if x is None else int(x)

    routes = {
        name: Route(
            payload=str(r.payload),
            send_idx=np.array(r.send_idx, dtype=np.int64),
            recv_key=np.array(r.recv_key, dtype=np.int64),
            items_ideal=int(r.items_ideal),
            items_padded=int(r.items_padded),
            word_size=int(r.word_size),
            words_ideal_override=opt_int(r.words_ideal_override),
            words_padded_override=opt_int(r.words_padded_override),
        )
        for name, r in obj.routes.items()
    }
    cls = {**_PLAN_CLASSES, "summa2d": SummaPlan}.get(str(obj.model), ExecutionPlan)
    return cls(
        model=str(obj.model),
        p=int(obj.p),
        ownership=arrays(obj.ownership),
        local_ids=arrays(obj.local_ids),
        routes=routes,
        compute=arrays(obj.compute),
        stats=dict(obj.stats),
    )


_PLAN_CLASSES = {
    "rowwise": RowwisePlan,
    "columnwise": RowwisePlan,
    "outer": OuterPlan,
    "fine": FinePlan,
    "monoA": FinePlan,
    "monoB": FinePlan,
    "monoC": MonoCPlan,
}


def moved_items(plan: ExecutionPlan) -> int:
    """Items one call of the plan's executor hands its collective: every
    valid slot of every route (a B row, a block, a scalar — one item each),
    plus the fold's padded words, since the outer plan's ``psum_scatter``
    reduces dense padded C row blocks whatever their sparsity."""
    items = sum(int((r.recv_key >= 0).sum()) for r in plan.routes.values())
    return items + int(plan.stats.get("fold_words_padded", 0))
