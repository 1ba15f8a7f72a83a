"""Multilevel K-way hypergraph partitioner.

PaToH stand-in: recursive bisection with
  (1) heavy-connectivity vertex clustering for coarsening (vectorized
      through a scipy sparse similarity product),
  (2) greedy BFS-style initial bisection under a compute-balance constraint,
  (3) boundary FM refinement with classic delta-gain updates, minimizing the
      connectivity metric sum_n c(n) * (lambda(n) - 1) (what PaToH minimizes,
      Sec. 6; for a bisection this equals the weighted cut),
  (4) a direct K-way boundary label-propagation pass after recursive
      bisection that recovers cut lost at bisection boundaries,
subject to w_comp(V_i) <= (1 + eps) * W / p (Def. 4.4 with delta = p - 1,
matching the paper's experiments).

Two engines share this driver (DESIGN.md §6); the module is a copy of
``repro.core.partition`` restricted to them, and the planning tests pin
equal partitions:

- ``engine="flat"`` (default): the flat-CSR refinement engine in
  ``core/refine.py`` — gain-bucket FM, vectorized frontier growth, star
  clustering with a vectorized similarity argmax, plus the K-way pass.
- ``engine="loop"``: the original per-move implementation, retained as the
  executable specification (``_fm_refine_loop`` / ``_initial_bisect_loop`` /
  ``_match_vertices_loop``).

The reference's ``engine="device"`` (a batched label-propagation V-cycle on
the accelerator) is not ported yet; asking for it raises.  The warm start
(``partition(..., warm_start=labels)``, ``_warm_partition``) is the
reference's: a previous partition's labels carried onto a drifted
structure, polished by one K-way pass.

Engineering notes (documented, standard heuristics):
- nets larger than ``BIG_NET`` pins are ignored during clustering and their
  delta-gain propagation is skipped (their contribution to gains is still
  counted when a vertex's gain is first computed); at the sizes we run,
  such nets are almost never uncuttable anyway.
- FM candidate set = vertices on cut nets (capped per pass in the loop
  engine).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import scipy.sparse as sp

from repro_torch.core.hypergraph import Hypergraph, build_hypergraph_flat
from repro_torch.core.refine import (
    BIG_NET,
    DEG_CAP,
    fm_refine,
    initial_bisect,
    kway_refine,
)

MAX_MOVES_PER_PASS = 1200  # loop-engine FM candidate cap
SMALL_DIRECT = 4096  # below this, the flat engine runs full per-bisection
# multilevel (quality path); above it, one shared V-cycle (speed path)
SMALL_STARTS = 4  # independent starts on the quality path (best kept)


@dataclasses.dataclass
class PartitionResult:
    parts: np.ndarray  # (n_vertices,) int64 part ids
    p: int
    connectivity: int  # final objective value
    warm: bool = False  # produced by the warm-start path (label reuse)


# ---------------------------------------------------------------------------
# coarsening
# ---------------------------------------------------------------------------
def _similarity(hg: Hypergraph, dtype=np.float64) -> sp.spmatrix:
    """sim(u, v) = sum over shared (small) nets of c(n)/(|n| - 1), with the
    diagonal kept (callers mask it entry-wise).  The result is symmetric, so
    callers may read its compressed-axis structure as rows whether scipy
    hands back CSR or CSC.

    Builds the weighted incidence directly in CSR form — nets are already
    pin-sorted, so filtering is a mask over the cached ``pin_nets()``
    expansion (hoisted, one gather) and the indptr a prefix sum over the
    filtered sizes.  The old per-level COO round trip paid a full
    sort-by-row in ``tocsr()`` for structure the level already had."""
    sizes = hg.net_sizes()
    ok = (sizes > 1) & (sizes <= BIG_NET)
    wfac = np.zeros(hg.n_nets, dtype=dtype)
    wfac[ok] = np.sqrt(
        hg.net_cost[ok].astype(dtype) / np.maximum(sizes[ok] - 1, 1).astype(dtype)
    )
    net_ids = hg.pin_nets()  # cached expansion, hoisted out of the filter
    keep = ok[net_ids]
    indptr = np.concatenate([[0], np.cumsum(np.where(ok, sizes, 0))])
    W = sp.csr_matrix(
        (wfac[net_ids[keep]], hg.net_pins[keep], indptr),
        shape=(hg.n_nets, hg.n_vertices),
    )
    S = W.T @ W
    if S.format not in ("csr", "csc"):
        S = S.tocsr()
    return S


def _best_partners(S: sp.spmatrix) -> tuple[np.ndarray, np.ndarray]:
    """Row-wise (argmax, max) of a symmetric similarity matrix excluding the
    diagonal, fully vectorized via one segmented ``maximum.reduceat`` — the
    diagonal is masked entry-wise, which sidesteps the scipy-1.14 ``setdiag``
    corruption the old per-row loop worked around with a COO rebuild.  ``S``
    may be CSR or CSC; symmetry makes the compressed axis a row either way."""
    n = S.shape[0]
    best = np.full(n, -1, dtype=np.int64)
    score = np.full(n, -1.0)
    lens = np.diff(S.indptr)
    nzr = np.flatnonzero(lens)
    if len(nzr) == 0:
        return best, score
    rows_rep = np.repeat(np.arange(n, dtype=np.int64), lens)
    data = np.where(S.indices == rows_rep, -1.0, S.data)
    rowmax = np.maximum.reduceat(data, S.indptr[nzr])
    hit = np.flatnonzero(data == np.repeat(rowmax, lens[nzr]))
    urow, first = np.unique(rows_rep[hit], return_index=True)
    best[urow] = S.indices[hit[first]]
    score[urow] = data[hit[first]]
    return best, score


def _cluster_vertices(
    hg: Hypergraph, max_weight: float, stars: bool = True
) -> np.ndarray:
    """Agglomerative clustering: each vertex proposes its best partner
    (vectorized row argmax of the similarity product); proposals are granted
    in descending-score order.  With ``stars=True`` later vertices may join
    an existing cluster while its weight stays under ``max_weight`` —
    multi-vertex clusters shrink the hypergraph ~3x per level, so the
    V-cycle is shorter.  With ``stars=False`` only pairs form (the quality
    path keeps more levels, like the loop reference's pairwise matching)."""
    n = hg.n_vertices
    best, score = _best_partners(_similarity(hg, dtype=np.float32))
    order = np.argsort(-score, kind="stable")
    cl = np.full(n, -1, dtype=np.int64)
    cl_w: list[float] = []
    wc = hg.w_comp.astype(np.float64)
    best_l = best.tolist()
    score_l = score.tolist()
    cl_l = cl.tolist()  # python list: the grant loop is scalar
    for v in order.tolist():
        if score_l[v] <= 0:
            break
        if cl_l[v] >= 0:
            continue
        u = best_l[v]
        cu = cl_l[u]
        if cu < 0:
            if wc[u] + wc[v] <= max_weight:
                cl_l[v] = cl_l[u] = len(cl_w)
                cl_w.append(wc[u] + wc[v])
        elif stars and cl_w[cu] + wc[v] <= max_weight:
            cl_l[v] = cu
            cl_w[cu] += wc[v]
    cl = np.array(cl_l, dtype=np.int64)
    singles = np.flatnonzero(cl < 0)
    cl[singles] = len(cl_w) + np.arange(len(singles))
    return cl


def _match_vertices_loop(
    hg: Hypergraph, rng: np.random.Generator, max_weight: float
) -> np.ndarray:
    """Loop-engine matcher (executable specification): pairwise
    heavy-connectivity matching with a per-row argmax loop; proposals are
    granted greedily in descending-score order."""
    S = _similarity(hg).tocoo()
    # drop the diagonal via an explicit COO filter: csr.setdiag(0) in scipy
    # 1.14 corrupts neighbouring entries when nearly the whole diagonal is
    # stored (stale offsets after _insert_many), leaving self-similarities
    # that make vertices match themselves
    off_diag = S.row != S.col
    S = sp.csr_matrix(
        (S.data[off_diag], (S.row[off_diag], S.col[off_diag])), shape=S.shape
    )
    n = hg.n_vertices
    best = np.full(n, -1, dtype=np.int64)
    score = np.zeros(n, dtype=np.float64)
    indptr, indices, data = S.indptr, S.indices, S.data
    nz_rows = np.flatnonzero(np.diff(indptr) > 0)
    for v in nz_rows:
        lo, hi = indptr[v], indptr[v + 1]
        j = lo + np.argmax(data[lo:hi])
        best[v] = indices[j]
        score[v] = data[j]
    order = np.argsort(-score, kind="stable")
    match = np.full(n, -1, dtype=np.int64)
    wc = hg.w_comp
    for v in order:
        u = best[v]
        if u < 0 or score[v] <= 0:
            break
        if match[v] < 0 and match[u] < 0 and wc[u] + wc[v] <= max_weight:
            match[v] = u
            match[u] = v
    coarse = np.full(n, -1, dtype=np.int64)
    # matched pairs get one id, singletons keep their own
    pair_lo = np.flatnonzero(match > np.arange(n))
    coarse[pair_lo] = np.arange(len(pair_lo))
    coarse[match[pair_lo]] = coarse[pair_lo]
    singles = np.flatnonzero(match < 0)
    coarse[singles] = len(pair_lo) + np.arange(len(singles))
    return coarse


def _coarsen(
    hg: Hypergraph, coarse: np.ndarray, big_net_cap: int | None = None
) -> tuple[Hypergraph, int]:
    """Contract vertices by ``coarse``; drop singletons (Sec. 5.1).

    ``big_net_cap``: additionally drop coarse nets with more pins than the
    cap (the flat engine passes ``BIG_NET``).  Contracted nets grow toward
    |V| pins, are excluded from similarity clustering and FM gain updates
    anyway, and are next to uncuttable — but still dominate the coarse
    graphs' pin counts if kept.  The loop reference keeps every net.

    Identical nets are NOT coalesced inside the V-cycle: duplicate nets yield
    exactly the same connectivity objective and FM gains (their costs add),
    so coalescing is a pure speed tradeoff — and the hashing dominated the
    profile."""
    n_coarse = int(coarse.max()) + 1
    w_comp = np.bincount(coarse, weights=hg.w_comp, minlength=n_coarse).astype(np.int64)
    w_mem = np.bincount(coarse, weights=hg.w_mem, minlength=n_coarse).astype(np.int64)

    net_ids = hg.pin_nets()
    pins = coarse[hg.net_pins]
    key = np.unique(net_ids * n_coarse + pins)
    net_ids, pins = key // n_coarse, key % n_coarse

    counts = np.bincount(net_ids, minlength=hg.n_nets)
    keep = (counts[net_ids] > 1) if big_net_cap is None else (
        (counts[net_ids] > 1) & (counts[net_ids] <= big_net_cap)
    )
    net_ids, pins = net_ids[keep], pins[keep]
    if len(net_ids) == 0:
        empty = np.empty(0, dtype=np.int64)
        return (
            build_hypergraph_flat(empty, empty, 0, n_coarse, w_comp, w_mem, empty),
            n_coarse,
        )
    uniq_nets, compact = np.unique(net_ids, return_inverse=True)
    return (
        build_hypergraph_flat(
            compact,
            pins,
            len(uniq_nets),
            n_coarse,
            w_comp,
            w_mem,
            hg.net_cost[uniq_nets],
        ),
        n_coarse,
    )


# ---------------------------------------------------------------------------
# loop-engine initial bisection + FM refinement (executable specification)
# ---------------------------------------------------------------------------
def _initial_bisect_loop(
    hg: Hypergraph, target0: float, rng: np.random.Generator
) -> np.ndarray:
    """Greedy net-BFS growth of side 0 up to ~target0 total compute weight."""
    n = hg.n_vertices
    side = np.ones(n, dtype=np.int8)
    ptr, vnets = hg.vertex_to_nets()
    net_ptr, net_pins = hg.net_ptr, hg.net_pins
    w = hg.w_comp.astype(np.float64)
    total0 = 0.0
    seed = int(rng.integers(n))
    frontier: deque[int] = deque([seed])
    seen = np.zeros(n, dtype=bool)
    seen[seed] = True
    while total0 < target0:
        if not frontier:
            rest = np.flatnonzero(~seen)
            if not len(rest):
                break
            s = int(rest[rng.integers(len(rest))])
            seen[s] = True
            frontier.append(s)
        v = frontier.popleft()
        if total0 + w[v] > target0 * 1.05 and total0 > 0:
            continue
        side[v] = 0
        total0 += w[v]
        for nid in vnets[ptr[v] : ptr[v + 1]]:
            pins = net_pins[net_ptr[nid] : net_ptr[nid + 1]]
            for u in pins:
                if not seen[u]:
                    seen[u] = True
                    frontier.append(u)
    return side


def _compute_counts(hg: Hypergraph, side: np.ndarray) -> np.ndarray:
    """(n_nets, 2) per-side pin counts."""
    net_ids = hg.pin_nets()
    pin_side = side[hg.net_pins]
    cnt = np.zeros((hg.n_nets, 2), dtype=np.int64)
    cnt[:, 1] = np.bincount(net_ids, weights=pin_side, minlength=hg.n_nets)
    cnt[:, 0] = hg.net_sizes() - cnt[:, 1]
    return cnt


def _gains_for_all(hg: Hypergraph, side: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """Vectorized FM gains for all vertices via two sparse matvecs:
    gain(v) = sum_{n in v} c(n)[cnt(n, side(v)) == 1] - c(n)[cnt(n, other) == 0]."""
    inc = hg.incidence()  # (n_nets, n_vertices) cached on the hypergraph
    cost = hg.net_cost.astype(np.float64)
    only0 = cost * (cnt[:, 0] == 1)
    only1 = cost * (cnt[:, 1] == 1)
    empty0 = cost * (cnt[:, 0] == 0)
    empty1 = cost * (cnt[:, 1] == 0)
    # per-vertex sums of each net quantity
    s_only0 = inc.T @ only0
    s_only1 = inc.T @ only1
    s_empty0 = inc.T @ empty0
    s_empty1 = inc.T @ empty1
    side_b = side.astype(bool)
    gains = np.where(side_b, s_only1 - s_empty0, s_only0 - s_empty1)
    return gains


def _fm_refine_loop(
    hg: Hypergraph,
    side: np.ndarray,
    max_w: tuple[float, float],
    passes: int = 2,
) -> np.ndarray:
    """Boundary FM with classic delta-gain updates and per-pass rollback.

    Retained as the executable specification of ``refine.fm_refine`` —
    per-move ``np.argmax`` best-move selection and per-net pin gathers;
    ``benchmarks/bench_partition.py`` measures the flat engine against it."""
    ptr, vnets = hg.vertex_to_nets()
    net_ptr, net_pins = hg.net_ptr, hg.net_pins
    cost = hg.net_cost.astype(np.float64)
    sizes = hg.net_sizes()
    small = sizes <= BIG_NET
    w = hg.w_comp.astype(np.float64)
    side = side.astype(np.int8).copy()

    for _pass in range(passes):
        cnt = _compute_counts(hg, side)
        side_w = np.array([w[side == 0].sum(), w[side == 1].sum()])
        cut = (cnt[:, 0] > 0) & (cnt[:, 1] > 0)
        if not cut.any():
            break
        all_gains = _gains_for_all(hg, side, cnt)
        # candidates: boundary vertices, best gains first (vectorized via the
        # per-pin net-id expansion)
        boundary = np.zeros(hg.n_vertices, dtype=bool)
        pin_cut = np.repeat(cut, sizes)
        boundary[net_pins[pin_cut]] = True
        deg = np.diff(ptr)
        cand = np.flatnonzero(boundary & (deg <= DEG_CAP))
        if len(cand) == 0:
            break
        if len(cand) > MAX_MOVES_PER_PASS:
            top = np.argsort(-all_gains[cand], kind="stable")[:MAX_MOVES_PER_PASS]
            cand = cand[top]
        pos_of = np.full(hg.n_vertices, -1, dtype=np.int64)
        pos_of[cand] = np.arange(len(cand))
        gains = all_gains[cand]
        locked = np.zeros(len(cand), dtype=bool)

        history: list[int] = []
        cum, best_cum, best_idx = 0.0, 0.0, -1
        NEG = -1e30
        g_work = gains.copy()
        for _move in range(len(cand)):
            g_masked = np.where(locked, NEG, g_work)
            # balance feasibility
            vs = cand
            s_arr = side[vs]
            feasible = side_w[1 - s_arr] + w[vs] <= np.array(max_w)[1 - s_arr]
            g_masked = np.where(feasible, g_masked, NEG)
            bi = int(np.argmax(g_masked))
            if g_masked[bi] <= NEG / 2:
                break
            bg = g_work[bi]
            v = int(cand[bi])
            s = int(side[v])
            t = 1 - s
            # --- apply move with vectorized delta-gain updates ---
            nets = vnets[ptr[v] : ptr[v + 1]]
            snets = nets[small[nets]]
            ct_before = cnt[snets, t]
            # rule 1: t-count was 0 -> all other free pins gain +c
            # rule 2: t-count was 1 -> the lone t-side free pin gains -c
            r1 = snets[ct_before == 0]
            r2 = snets[ct_before == 1]
            cnt[nets, s] -= 1
            cnt[nets, t] += 1
            cs_after = cnt[snets, s]
            # rule 3: s-count now 0 -> all other free pins gain -c
            # rule 4: s-count now 1 -> the lone s-side free pin gains +c
            r3 = snets[cs_after == 0]
            r4 = snets[cs_after == 1]

            def _apply(rule_nets, sign, side_filter):
                if len(rule_nets) == 0:
                    return
                pins = np.concatenate(
                    [net_pins[net_ptr[n] : net_ptr[n + 1]] for n in rule_nets]
                )
                cs = np.repeat(cost[rule_nets],
                               net_ptr[rule_nets + 1] - net_ptr[rule_nets])
                pu = pos_of[pins]
                m = (pu >= 0) & (pins != v)
                if side_filter is not None:
                    m &= side[pins] == side_filter
                pu = pu[m]
                m2 = ~locked[pu]
                np.add.at(g_work, pu[m2], sign * cs[m][m2])

            _apply(r1, +1.0, None)
            _apply(r2, -1.0, t)
            _apply(r3, -1.0, None)
            _apply(r4, +1.0, s)
            side[v] = t
            side_w[s] -= w[v]
            side_w[t] += w[v]
            locked[bi] = True
            history.append(v)
            cum += bg
            if cum > best_cum + 1e-9:
                best_cum, best_idx = cum, len(history) - 1
            if bg < 0 and len(history) - 1 - best_idx > 50:
                break  # hill-descent cutoff
        # rollback to best prefix
        for v in history[best_idx + 1 :]:
            s = int(side[v])
            side[v] = 1 - s
            side_w[s] -= w[v]
            side_w[1 - s] += w[v]
        if best_cum <= 0:
            break
    return side


# ---------------------------------------------------------------------------
# multilevel bisection drivers
# ---------------------------------------------------------------------------
def _bisect(
    hg: Hypergraph,
    k0: int,
    k1: int,
    part_cap: float,
    rng: np.random.Generator,
    coarsen_to: int = 160,
    engine: str = "flat",
    multilevel: bool = True,
) -> np.ndarray:
    """Multilevel bisection into sides destined for k0 and k1 parts.

    ``part_cap`` is the GLOBAL maximum per-part weight (1+eps) * W_total / p;
    the side caps are k_side * part_cap so imbalance cannot compound down the
    recursion.

    With ``multilevel=False`` the flat engine skips per-bisection
    coarsening: ``partition`` already ran the shared global V-cycle, so this
    bisects what is effectively a coarse graph directly (initial growth +
    gain-bucket FM).  The loop engine always re-coarsens each subproblem
    with pairwise matching, as the original implementation did."""
    total = float(hg.w_comp.sum())
    frac0 = k0 / (k0 + k1)
    max_w = (k0 * part_cap, k1 * part_cap)
    levels: list[tuple[Hypergraph, np.ndarray]] = []
    cur = hg
    if engine == "loop" or multilevel:
        heaviest = float(cur.w_comp.max()) if cur.n_vertices else 0.0
        cluster_cap = max(total / 10, heaviest)
        while cur.n_vertices > coarsen_to:
            if engine == "flat":
                cmap = _cluster_vertices(cur, max_weight=cluster_cap)
                nxt, n_coarse = _coarsen(cur, cmap, big_net_cap=BIG_NET)
            else:
                cmap = _match_vertices_loop(cur, rng, max_weight=cluster_cap)
                nxt, n_coarse = _coarsen(cur, cmap)
            if n_coarse >= cur.n_vertices * 0.95:  # clustering stalled
                break
            levels.append((cur, cmap))
            cur = nxt

    if engine == "flat":
        # tiny graphs get extra passes — each pass rolls back to its best
        # prefix, so per-bisection passes are monotone and nearly free here
        passes = 4 if hg.n_vertices <= 512 else 2
        side = initial_bisect(
            cur,
            min(total * frac0, max_w[0]),
            rng,
            min0=total - max_w[1],  # side 1 must end under its own cap
        )
        side = fm_refine(cur, side, max_w, max_passes=passes)
        for fine, cmap in reversed(levels):
            side = side[cmap]
            side = fm_refine(fine, side, max_w, max_passes=passes)
    else:
        side = _initial_bisect_loop(cur, min(total * frac0, max_w[0]), rng)
        side = _fm_refine_loop(cur, side, max_w)
        for fine, cmap in reversed(levels):
            side = side[cmap]
            side = _fm_refine_loop(fine, side, max_w)
    return side


def _restrict(hg: Hypergraph, mask: np.ndarray) -> tuple[Hypergraph, np.ndarray]:
    """Sub-hypergraph induced on ``mask`` vertices (nets restricted, singletons
    dropped).  Returns (sub, original-ids-of-sub-vertices)."""
    ids = np.flatnonzero(mask)
    remap = np.full(hg.n_vertices, -1, dtype=np.int64)
    remap[ids] = np.arange(len(ids))
    net_ids = hg.pin_nets()
    keep = mask[hg.net_pins]
    net_ids = net_ids[keep]
    pins = remap[hg.net_pins[keep]]
    counts = np.bincount(net_ids, minlength=hg.n_nets)
    keep2 = counts[net_ids] > 1
    net_ids, pins = net_ids[keep2], pins[keep2]
    uniq, new_net = np.unique(net_ids, return_inverse=True)
    sub = build_hypergraph_flat(
        new_net,
        pins,
        len(uniq),
        len(ids),
        hg.w_comp[ids],
        hg.w_mem[ids],
        hg.net_cost[uniq],
    )
    return sub, ids


def _recursive_bisection(
    hg: Hypergraph,
    p: int,
    part_cap: float,
    rng: np.random.Generator,
    engine: str,
    multilevel: bool = True,
) -> np.ndarray:
    """K-way partition of ``hg`` via recursive bisection."""
    parts = np.zeros(hg.n_vertices, dtype=np.int64)
    stack: list[tuple[Hypergraph, np.ndarray, int, int]] = [
        (hg, np.arange(hg.n_vertices), 0, p)
    ]
    while stack:
        sub, ids, lo, hi = stack.pop()
        k = hi - lo
        if k == 1:
            parts[ids] = lo
            continue
        k0 = k // 2
        side = _bisect(
            sub, k0, k - k0, part_cap, rng, engine=engine, multilevel=multilevel
        )
        for s, plo, phi in ((0, lo, lo + k0), (1, lo + k0, hi)):
            mask = side == s
            if not mask.any():
                continue
            if phi - plo == 1:
                parts[ids[mask]] = plo
            else:
                ssub, sids = _restrict(sub, mask)
                stack.append((ssub, ids[mask], plo, phi))
    return parts


def _global_vcycle(
    hg: Hypergraph, p: int, part_cap: float
) -> tuple[list[tuple[Hypergraph, np.ndarray]], Hypergraph]:
    """The shared global V-cycle of the speed paths: cluster caps stay well
    under a part so the coarse initial partitions can still balance.  Returns
    (levels fine-to-coarse, coarsest hypergraph)."""
    total = float(hg.w_comp.sum())
    cluster_cap = max(min(total / 10, part_cap / 4), float(hg.w_comp.max()))
    glob_target = max(256, 16 * p)
    levels: list[tuple[Hypergraph, np.ndarray]] = []
    cur = hg
    while cur.n_vertices > glob_target:
        cmap = _cluster_vertices(cur, max_weight=cluster_cap)
        nxt, n_coarse = _coarsen(cur, cmap, big_net_cap=BIG_NET)
        # a nearly-stalled level buys no structure but costs a cluster +
        # K-way pass each; 0.8 keeps only useful levels
        if n_coarse >= cur.n_vertices * 0.8:
            break
        levels.append((cur, cmap))
        cur = nxt
    return levels, cur


def _warm_partition(
    hg: Hypergraph, p: int, part_cap: float, labels: np.ndarray, drift_limit: float
) -> np.ndarray | None:
    """Warm-start K-way partition from a previous run's labels.

    ``labels`` is aligned to this hypergraph's vertices; entries outside
    ``[0, p)`` mark vertices the caller could not map from the old structure
    (new rows/mults after drift).  Unmapped vertices are placed
    heaviest-first onto the lightest part, then one ``kway_refine`` polish
    repairs the boundary the drift disturbed.  Returns ``None`` — caller
    falls back to cold partitioning — when drift exceeds ``drift_limit`` or
    the polished result is balance-infeasible (reusing labels would then
    cost more than it saves)."""
    labels = np.asarray(labels, dtype=np.int64).ravel()
    if labels.shape != (hg.n_vertices,):
        return None
    invalid = (labels < 0) | (labels >= p)
    if float(invalid.mean()) > drift_limit:
        return None
    parts = labels.copy()
    miss = np.flatnonzero(invalid)
    w = hg.w_comp.astype(np.float64)
    if len(miss):
        part_w = np.bincount(parts[~invalid], weights=w[~invalid], minlength=p)
        order = miss[np.argsort(-w[miss], kind="stable")]
        for v in order.tolist():
            t = int(np.argmin(part_w))
            parts[v] = t
            part_w[t] += w[v]
    parts = kway_refine(hg, parts, p, part_cap)
    part_w = np.bincount(parts, weights=w, minlength=p)
    if part_w.max() > part_cap + 1e-9:
        return None
    return parts


def partition(
    hg: Hypergraph,
    p: int,
    eps: float = 0.03,
    seed: int = 0,
    engine: str = "flat",
    warm_start: np.ndarray | None = None,
    warm_drift_limit: float = 0.5,
) -> PartitionResult:
    """K-way partition via recursive bisection (+ a direct K-way pass).

    ``engine="flat"`` is the gain-bucket flat-CSR engine (``core/refine.py``).
    It shares one global V-cycle across the whole call: the fine hypergraph
    is clustered once, recursive bisection runs on the coarse graph (where
    its own inner cycles are nearly free), and each uncoarsening step is
    followed by the direct K-way boundary pass — so the per-move refinement
    never touches the finest graphs once per bisection the way the loop
    engine does.

    ``engine="loop"`` is the retained per-move reference implementation:
    recursive bisection directly on the fine hypergraph, re-coarsening each
    subproblem with pairwise matching.

    ``warm_start``: previous labels aligned to this hypergraph's vertices
    (entries outside ``[0, p)`` = unmapped after drift).  When reuse is
    viable (drift under ``warm_drift_limit`` and the polished result
    feasible) the returned result has ``warm=True`` and skipped the full
    multilevel search; otherwise cold partitioning runs with the requested
    engine.
    """
    from repro_torch.core.comm import evaluate
    from repro_torch.testing import faults

    faults.fire("partition")
    if engine == "device":
        raise ValueError(
            "engine='device' is not ported yet (ROADMAP.md, Queue 1: the "
            "device partitioner engine); use engine='flat' or 'loop'"
        )
    if engine not in ("flat", "loop"):
        raise ValueError(f"unknown partition engine {engine!r}")
    if warm_start is not None and hg.n_vertices:
        if p == 1:
            parts = np.zeros(hg.n_vertices, dtype=np.int64)
            conn = evaluate(hg, parts, p).connectivity
            return PartitionResult(parts=parts, p=p, connectivity=conn, warm=True)
        total = float(hg.w_comp.sum())
        part_cap = max((1 + eps) * total / p, float(hg.w_comp.max()))
        parts = _warm_partition(hg, p, part_cap, warm_start, warm_drift_limit)
        if parts is not None:
            conn = evaluate(hg, parts, p).connectivity
            return PartitionResult(parts=parts, p=p, connectivity=conn, warm=True)
    rng = np.random.default_rng(seed)
    parts = np.zeros(hg.n_vertices, dtype=np.int64)
    if p > 1 and hg.n_vertices:
        # global per-part cap; heavy vertices can force violations (the paper
        # observes exactly this for 1D models on scale-free inputs, Sec. 6.3)
        total = float(hg.w_comp.sum())
        part_cap = max((1 + eps) * total / p, float(hg.w_comp.max()))
        if engine == "flat" and hg.n_vertices > SMALL_DIRECT:
            # speed path: one shared global V-cycle
            levels, cur = _global_vcycle(hg, p, part_cap)
            parts_cur = _recursive_bisection(
                cur, p, part_cap, rng, engine, multilevel=False
            )
            parts_cur = kway_refine(cur, parts_cur, p, part_cap)
            for fine, cmap in reversed(levels):
                parts_cur = parts_cur[cmap]
                parts_cur = kway_refine(fine, parts_cur, p, part_cap)
            parts = parts_cur
        elif engine == "flat":
            # quality path: full per-bisection multilevel + K-way pass, and
            # the engine is fast enough at this size to take the best of a
            # few independent starts (still deterministic for a fixed seed).
            # Starts rank by (balance feasibility, connectivity): a feasible
            # start always beats an infeasible one, however good its cut.
            best_key = None
            for _try in range(SMALL_STARTS):
                cand = _recursive_bisection(hg, p, part_cap, rng, engine)
                cand = kway_refine(hg, cand, p, part_cap, max_rounds=16)
                conn = evaluate(hg, cand, p).connectivity
                cand_w = np.bincount(cand, weights=hg.w_comp, minlength=p)
                infeasible = bool(cand_w.max() > part_cap + 1e-9)
                key = (infeasible, conn)
                if best_key is None or key < best_key:
                    best_key, parts = key, cand
        else:
            parts = _recursive_bisection(hg, p, part_cap, rng, engine)
    conn = evaluate(hg, parts, p).connectivity
    return PartitionResult(parts=parts, p=p, connectivity=conn)

