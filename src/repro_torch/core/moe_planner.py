"""MoE dispatch comm planner (the paper's technique applied to the LM stack);
a copy of ``repro.core.moe_planner``, pinned equal to it by the tests.

The MoE dispatch is an SpGEMM: ``expert_in = D^T X`` with D the (tokens x
experts) routing structure.  Distributing experts over the 'model' axis is a
*monochrome-B / row-wise coarsening* of the dispatch SpGEMM hypergraph
(Sec. 5 of the paper): one vertex per expert (w_comp = its routed token
count), one net per token group (cost = group size x d_model words), cut =
token groups needed by more than one expert column, i.e. exactly the
all-to-all volume of an expert-parallel executor.

Partitioning this hypergraph (Thm. 4.5: min over balanced partitions of the
max per-part boundary cost) yields an expert -> column placement that
simultaneously
  (a) minimizes dispatch traffic for an all-to-all executor, and
  (b) balances routed load across columns (less capacity dropping for the
      replicated-token expert-parallel executor; on one card the port's
      ``models.layers.moe_layer`` takes the plain path).

Following the paper's own guidance (Sec. 7), planning is offline/amortized:
routing statistics come from profiling steps; the placement is then frozen
into ``MoEConfig.expert_placement``
(``repro_torch.models.config``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.comm import evaluate
from repro_torch.core.partition import partition
from repro_torch.core.spgemm_models import SpGEMMInstance, build_model
from repro_torch.sparse.structure import SparseStructure, from_coo


@dataclasses.dataclass
class PlacementPlan:
    placement: np.ndarray  # (E,) new expert id for expert e (permutation)
    column_of: np.ndarray  # (E,) expert column assignment
    comm_planned: int  # cut cost (token-group words crossing columns)
    comm_contiguous: int  # same metric for the naive [0..E) blocking
    load_imbalance_planned: float
    load_imbalance_contiguous: float


def routing_counts(gate_idx: np.ndarray, n_experts: int, n_groups: int) -> np.ndarray:
    """Aggregate observed top-k routing (T, K) into (n_groups, E) counts;
    groups are contiguous token spans (sequence locality ~ routing locality).
    """
    T = gate_idx.shape[0]
    group = (np.arange(T) * n_groups // T).astype(np.int64)
    counts = np.zeros((n_groups, n_experts), dtype=np.int64)
    np.add.at(counts, (group[:, None], gate_idx), 1)
    return counts


def dispatch_instance(counts: np.ndarray) -> SpGEMMInstance:
    """SpGEMM instance of the dispatch D^T X from grouped routing counts:
    A = D^T structure (E x G), B = X structure (G x 1, dense column)."""
    G, E = counts.shape
    g, e = np.nonzero(counts)
    a = from_coo(e, g, (E, G))  # D^T
    b = from_coo(np.arange(G), np.zeros(G, dtype=np.int64), (G, 1))
    return SpGEMMInstance(a, b, name="moe-dispatch")


def plan_expert_placement(
    counts: np.ndarray,
    n_columns: int,
    eps: float = 0.05,
    seed: int = 0,
) -> PlacementPlan:
    """Partition the dispatch hypergraph; experts co-routed with the same
    token groups land on the same column."""
    G, E = counts.shape
    if E % n_columns:
        raise ValueError(f"E={E} not divisible by columns={n_columns}")
    inst = dispatch_instance(counts)
    hg = build_model(inst, "rowwise")  # vertices = experts, nets = groups
    # weights: routed token counts (not just flop structure)
    hg.w_comp = counts.sum(axis=0).astype(np.int64)
    hg.net_cost = counts.sum(axis=1).astype(np.int64)  # words per group net

    res = partition(hg, n_columns, eps=eps, seed=seed)
    col = res.parts
    # contiguous baseline: expert e -> column e // (E / n_columns)
    e_loc = E // n_columns
    col_naive = np.arange(E) // e_loc

    planned = evaluate(hg, col, n_columns)
    naive = evaluate(hg, col_naive, n_columns)

    # build the permutation: experts sorted by column, stable within column
    order = np.lexsort((np.arange(E), col))
    # balance column sizes exactly (the executor needs E_loc per column):
    # round-robin spill of over-full columns
    placement = np.empty(E, dtype=np.int64)
    buckets: list[list[int]] = [[] for _ in range(n_columns)]
    for e in order:
        buckets[col[e]].append(int(e))
    overflow: list[int] = []
    for c in range(n_columns):
        while len(buckets[c]) > e_loc:
            overflow.append(buckets[c].pop())
    for c in range(n_columns):
        while len(buckets[c]) < e_loc:
            buckets[c].append(overflow.pop())
    col_final = np.empty(E, dtype=np.int64)
    for c in range(n_columns):
        for slot, e in enumerate(buckets[c]):
            placement[e] = c * e_loc + slot
            col_final[e] = c
    final = evaluate(hg, col_final, n_columns)

    load = counts.sum(axis=0).astype(np.float64)
    total = load.sum()

    def imb(assign):
        per_col = np.bincount(assign, weights=load, minlength=n_columns)
        return float(per_col.max() / (total / n_columns) - 1.0)

    return PlacementPlan(
        placement=placement,
        column_of=col_final,
        comm_planned=final.max_part_cost,
        comm_contiguous=naive.max_part_cost,
        load_imbalance_planned=imb(col_final),
        load_imbalance_contiguous=imb(col_naive),
    )
