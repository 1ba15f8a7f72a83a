"""Vertex coarsening (Sec. 5.1) and the derived special models (a copy of
``repro.core.coarsen``, pinned equal to it by the tests).

- ``coarsen_vertices``: the generic monochrome-set contraction with net
  membership update, weight summation, net coalescing and singleton removal.
- SpMV specializations (Sec. 5.5): column-net (row-wise SpMV), row-net
  (column-wise SpMV), and the Çatalyürek–Aykanat fine-grain model.
- Generalizations (Sec. 5.6): symmetric-input coarsening and masked SpGEMM.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.hypergraph import Hypergraph, build_hypergraph_flat
from repro_torch.core.spgemm_models import SpGEMMInstance, _build_fine, _lin_lookup
from repro_torch.sparse.structure import SparseStructure, from_coo


def coarsen_vertices(
    hg: Hypergraph,
    coarse_of: np.ndarray,
    unit_mem: bool = False,
    unit_comp: bool = False,
    drop_singletons: bool = True,
) -> Hypergraph:
    """Contract vertices according to ``coarse_of`` (vertex -> coarse id).

    Weights sum by default (Sec. 5.1); ``unit_mem``/``unit_comp`` clamp
    coarse weights to min(w, 1) — the Sec. 5.6.1 variant where coarsening
    models *deduplication* (store/compute once) rather than co-location.
    Coalesced nets are combined (cost = summed, or kept if dedup semantics).
    """
    n_coarse = int(coarse_of.max()) + 1
    w_comp = np.bincount(coarse_of, weights=hg.w_comp, minlength=n_coarse).astype(
        np.int64
    )
    w_mem = np.bincount(coarse_of, weights=hg.w_mem, minlength=n_coarse).astype(
        np.int64
    )
    if unit_comp:
        w_comp = np.minimum(w_comp, 1)
    if unit_mem:
        w_mem = np.minimum(w_mem, 1)

    net_ids = np.repeat(np.arange(hg.n_nets, dtype=np.int64), hg.net_sizes())
    pins = coarse_of[hg.net_pins]
    key = np.unique(net_ids * n_coarse + pins)
    net_ids, pins = key // n_coarse, key % n_coarse

    if drop_singletons:
        counts = np.bincount(net_ids, minlength=hg.n_nets)
        keep = counts[net_ids] > 1
        net_ids, pins = net_ids[keep], pins[keep]

    # coalesce identical nets
    order = np.lexsort((pins, net_ids))
    net_ids, pins = net_ids[order], pins[order]
    uniq_nets, start = np.unique(net_ids, return_index=True)
    end = np.append(start[1:], len(net_ids))
    sig: dict[bytes, int] = {}
    out_cost: list[int] = []
    out_kind: list[int] = []
    out_ids: list[np.ndarray] = []
    out_pins: list[np.ndarray] = []
    has_kind = hg.net_kind is not None
    for idx in range(len(uniq_nets)):
        s, e = start[idx], end[idx]
        k = pins[s:e].tobytes()
        c = int(hg.net_cost[uniq_nets[idx]])
        if k in sig:
            out_cost[sig[k]] += 0 if (unit_mem or unit_comp) else c
            continue
        sig[k] = len(out_cost)
        out_cost.append(c)
        if has_kind:
            out_kind.append(int(hg.net_kind[uniq_nets[idx]]))
        out_ids.append(np.full(e - s, sig[k], dtype=np.int64))
        out_pins.append(pins[s:e])
    if not out_ids:
        empty = np.empty(0, dtype=np.int64)
        return build_hypergraph_flat(
            empty, empty, 0, n_coarse, w_comp, w_mem, empty, name=hg.name + "+coarse"
        )
    return build_hypergraph_flat(
        np.concatenate(out_ids),
        np.concatenate(out_pins),
        len(out_cost),
        n_coarse,
        w_comp,
        w_mem,
        np.array(out_cost, dtype=np.int64),
        net_kind=np.array(out_kind, dtype=np.int8) if has_kind else None,
        name=hg.name + "+coarse",
    )


# ---------------------------------------------------------------------------
# SpMV (Sec. 5.5)
# ---------------------------------------------------------------------------
def spmv_column_net(a: SparseStructure) -> Hypergraph:
    """Column-net model (row-wise SpMV): vertex per matrix row, net per
    column; identical to row-wise SpGEMM (Ex. 5.1) with a dense vector B,
    minus B-vertices and memory weights."""
    I, K = a.shape
    acsc = a.tocsc()
    net_ids = np.repeat(np.arange(K, dtype=np.int64), np.diff(acsc.indptr))
    return build_hypergraph_flat(
        net_ids,
        acsc.indices.astype(np.int64),
        K,
        I,
        a.row_counts().astype(np.int64),
        np.zeros(I, dtype=np.int64),
        np.ones(K, dtype=np.int64),
        name="spmv-colnet",
    )


def spmv_row_net(a: SparseStructure) -> Hypergraph:
    """Row-net model (column-wise SpMV): vertex per column, net per row."""
    I, K = a.shape
    net_ids = np.repeat(np.arange(I, dtype=np.int64), np.diff(a.csr.indptr))
    return build_hypergraph_flat(
        net_ids,
        a.indices.astype(np.int64),
        I,
        K,
        a.col_counts().astype(np.int64),
        np.zeros(K, dtype=np.int64),
        np.ones(I, dtype=np.int64),
        name="spmv-rownet",
    )


def spmv_fine_grain(a: SparseStructure) -> Hypergraph:
    """Çatalyürek–Aykanat fine-grain SpMV model (square A): one vertex per
    nonzero (+ dummy diagonal vertices), one net per row and per column,
    derived exactly as Sec. 5.5 prescribes: monochrome-A coarsening of the
    SpGEMM hypergraph with a dense vector, then diagonal symmetrization."""
    I, K = a.shape
    if I != K:
        raise ValueError("fine-grain SpMV model assumes square A")
    nA = a.nnz
    r, c = a.coo()
    has_diag = np.zeros(I, dtype=bool)
    diag_pos = np.full(I, -1, dtype=np.int64)
    on_diag = r == c
    has_diag[r[on_diag]] = True
    diag_pos[r[on_diag]] = np.flatnonzero(on_diag)
    n_dummy = int((~has_diag).sum())
    # vertex ids: nonzeros [0, nA), dummies for missing diagonals after that
    dummy_of = np.full(I, -1, dtype=np.int64)
    dummy_of[~has_diag] = nA + np.arange(n_dummy)
    vertex_of_diag = np.where(has_diag, diag_pos, dummy_of)
    n_vertices = nA + n_dummy

    # row nets (fold: output entries) and column nets (expand: input entries)
    row_net = np.repeat(np.arange(I, dtype=np.int64), a.row_counts())
    col_net = I + c
    # each diagonal-vertex also belongs to its row and column net
    net_ids = np.concatenate([row_net, col_net, np.arange(I), I + np.arange(I)])
    pin_vs = np.concatenate(
        [np.arange(nA), np.arange(nA), vertex_of_diag, vertex_of_diag]
    )
    # dedupe (diagonal nonzeros appear twice)
    key = np.unique(net_ids * n_vertices + pin_vs)
    net_ids, pin_vs = key // n_vertices, key % n_vertices

    w_comp = np.concatenate(
        [np.ones(nA, dtype=np.int64), np.zeros(n_dummy, dtype=np.int64)]
    )
    w_mem = np.ones(n_vertices, dtype=np.int64)
    w_mem[:nA] = 1
    w_mem[vertex_of_diag] += 2  # owns x_i and y_i  (w_mem 3 if diag nz else 2)
    w_mem[vertex_of_diag[~has_diag]] -= 1  # dummies: no matrix entry
    return build_hypergraph_flat(
        net_ids,
        pin_vs,
        2 * I,
        n_vertices,
        w_comp,
        w_mem,
        np.ones(2 * I, dtype=np.int64),
        name="spmv-finegrain",
    )


# ---------------------------------------------------------------------------
# Masked SpGEMM (Sec. 5.6.2)
# ---------------------------------------------------------------------------
def masked_fine_grained(inst: SpGEMMInstance, mask: SparseStructure) -> Hypergraph:
    """Fine-grained hypergraph restricted to C entries in ``mask``: removes
    masked C nets and their multiplication vertices, then drops A/B nets that
    became singletons (entries no longer used)."""
    keep_c = mask.csr.multiply(inst.c.csr)  # S = S_C ∩ S_M
    s = SparseStructure.wrap(keep_c)
    # which multiplications survive
    c_pos_all = _lin_lookup(inst.c, inst.mult_i, inst.mult_j)
    r, c = inst.c.coo()
    surviving_c = np.zeros(inst.c.nnz, dtype=bool)
    sr, sc = s.coo()
    lin_c = r * inst.c.shape[1] + c
    lin_s = sr * inst.c.shape[1] + sc
    surviving_c[np.searchsorted(lin_c, lin_s)] = True
    keep_mult = surviving_c[c_pos_all]

    sub = SpGEMMInstance.__new__(SpGEMMInstance)
    sub.a, sub.b, sub.name = inst.a, inst.b, inst.name + "+mask"
    sub.c = s
    sub.mult_i = inst.mult_i[keep_mult]
    sub.mult_k = inst.mult_k[keep_mult]
    sub.mult_j = inst.mult_j[keep_mult]
    sub.n_mult = int(keep_mult.sum())
    hg = _build_fine(sub, include_nz=True)
    from repro_torch.core.hypergraph import remove_singleton_nets

    return remove_singleton_nets(hg)


# ---------------------------------------------------------------------------
# Symmetric-input coarsening (Sec. 5.6.1, equality relation A = A^T)
# ---------------------------------------------------------------------------
def symmetric_input_coarse_map(inst: SpGEMMInstance) -> np.ndarray:
    """For A = A^T: group each off-diagonal pair (v^A_ik, v^A_ki) into one
    coarse vertex (store one copy).  Returns a coarse map over the
    fine-grained hypergraph *with* nz vertices."""
    a = inst.a
    M = inst.n_mult
    nA, nB, nC = a.nnz, inst.b.nnz, inst.c.nnz
    n = M + nA + nB + nC
    coarse = np.arange(n, dtype=np.int64)
    r, c = a.coo()
    # pair (i,k) with (k,i): map the higher CSR position onto the lower
    upper = r < c
    rows_u, cols_u = r[upper], c[upper]
    pos_u = _lin_lookup(a, rows_u, cols_u)
    pos_l = _lin_lookup(a, cols_u, rows_u)
    coarse[M + pos_u] = M + pos_l
    # compact ids
    _, coarse = np.unique(coarse, return_inverse=True)
    return coarse
