"""Communication cost evaluation and lower bounds (Sec. 4, Sec. 6).

A copy of ``repro.core.comm`` without the sequential I/O estimate.

Given a hypergraph and a p-way partition (vertex -> part id):

- ``part_cut_costs``: per-part sum of boundary-net costs, i.e. the
  |Q_i|-weighted cost of Lemma 4.2 / Def. 4.1.  The paper's reported metric is
  ``max_i``; the per-part vector also yields total volume.
- ``connectivity_cost``: PaToH's objective, sum_n c(n) * (lambda(n) - 1).
- ``expand_fold_split``: volume attributed to A/B nets (expand phase) vs C
  nets (fold phase).
- eq. (1) baselines: memory-dependent and memory-independent lower bounds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from repro_torch.core.hypergraph import Hypergraph


def _net_part_counts(hg: Hypergraph, parts: np.ndarray, p: int) -> sp.csr_matrix:
    """(n_nets x p) matrix of per-net pin counts per part."""
    pin_parts = parts[hg.net_pins]
    net_ids = hg.pin_nets()  # cached on the hypergraph, like incidence()
    m = sp.coo_matrix(
        (np.ones(hg.n_pins, dtype=np.int64), (net_ids, pin_parts)),
        shape=(hg.n_nets, p),
    )
    return m.tocsr()


@dataclasses.dataclass(frozen=True)
class CommCosts:
    max_part_cost: int  # max_i sum_{n in Q_i} c(n)  (paper's reported metric)
    total_volume: int  # sum_n c(n) * lambda(n) over cut nets (send+recv words)
    connectivity: int  # sum_n c(n) * (lambda(n) - 1)   (PaToH objective)
    per_part: np.ndarray  # (p,) boundary cost per part
    expand: int  # connectivity volume on A/B nets
    fold: int  # connectivity volume on C nets
    comp_imbalance: float  # max_i w_comp(V_i) / (W/p) - 1
    mem_imbalance: float


def evaluate(hg: Hypergraph, parts: np.ndarray, p: int | None = None) -> CommCosts:
    parts = np.asarray(parts, dtype=np.int64)
    if p is None:
        p = int(parts.max()) + 1 if len(parts) else 1
    counts = _net_part_counts(hg, parts, p)
    lam = np.diff(counts.indptr)  # connectivity lambda(n)
    cut = lam > 1
    cost = hg.net_cost

    connectivity = int((cost * np.maximum(lam - 1, 0)).sum())
    total_volume = int((cost * np.where(cut, lam, 0)).sum())

    # per-part boundary cost: for each part q, sum of costs of nets that touch
    # q and at least one other part.
    cut_counts = counts[cut]
    cut_cost = cost[cut]
    incident = cut_counts.tocoo()
    per_part = np.bincount(
        incident.col, weights=cut_cost[incident.row], minlength=p
    ).astype(np.int64)

    if hg.net_kind is not None:
        is_c = hg.net_kind == 3
        fold = int((cost * np.maximum(lam - 1, 0))[cut & is_c].sum())
        expand = connectivity - fold
    else:
        expand = connectivity
        fold = 0

    wc = np.bincount(parts, weights=hg.w_comp, minlength=p)
    wm = np.bincount(parts, weights=hg.w_mem, minlength=p)
    tc, tm = hg.w_comp.sum(), hg.w_mem.sum()
    comp_imb = float(wc.max() / (tc / p) - 1.0) if tc else 0.0
    mem_imb = float(wm.max() / (tm / p) - 1.0) if tm else 0.0
    return CommCosts(
        max_part_cost=int(per_part.max()) if p else 0,
        total_volume=total_volume,
        connectivity=connectivity,
        per_part=per_part,
        expand=expand,
        fold=fold,
        comp_imbalance=comp_imb,
        mem_imbalance=mem_imb,
    )


# ---------------------------------------------------------------------------
# Classical lower bounds, eq. (1)
# ---------------------------------------------------------------------------
def memory_dependent_bound(n_mult: int, p: int, local_mem: float) -> float:
    """Omega(|V^m| / (p sqrt(M)) - alpha M), constants dropped (alpha = 0)."""
    return n_mult / (p * np.sqrt(local_mem))


def memory_independent_bound(n_mult: int, n_nz: int, p: int, beta: float = 1.0) -> float:
    """Omega(|V^m|^{2/3} / p^{2/3} - beta |V^nz| / p)."""
    return max(n_mult ** (2 / 3) / p ** (2 / 3) - beta * n_nz / p, 0.0)


def classical_bound(n_mult: int, n_nz: int, p: int, local_mem: float) -> float:
    return max(
        memory_dependent_bound(n_mult, p, local_mem),
        memory_independent_bound(n_mult, n_nz, p),
    )

