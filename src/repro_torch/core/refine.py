"""Flat-CSR refinement engine for the multilevel partitioner (DESIGN.md §6).

Everything here operates on the Hypergraph's flat CSR arrays (``net_ptr`` /
``net_pins`` and the cached vertex→nets transpose): a move touches only
index arithmetic over those arrays — no per-net Python list building inside
the move loops.  Three pieces:

- ``fm_refine``: boundary FM bisection refinement.  Best-move selection is
  O(1) amortized through gain buckets (one list of candidates per distinct
  integer gain + a lazy max-key heap); delta-gain updates are O(deg) flat
  gathers with stale bucket entries invalidated on pop.  The (net, side)
  pin-count table is maintained incrementally across moves, rollbacks and
  passes instead of being recomputed per pass.
- ``initial_bisect``: vectorized frontier growth — whole BFS levels at a
  time with a weight-prefix cut inside the level that crosses the target.
- ``kway_refine``: direct K-way greedy boundary label propagation over all
  p parts, run after recursive bisection.  Every applied move is
  re-validated against the current pin counts, so each one strictly
  decreases sum_n c(n)·(lambda(n)-1) and respects the Def. 4.4 balance cap:
  the pass is monotone in both objective and feasibility.

``fm_refine`` is behaviour-compatible with the retained executable
specification ``partition._fm_refine_loop`` (same gain rules 1–4, same
BIG_NET / DEG_CAP screens, per-pass rollback to the best prefix); it is not
move-for-move identical — the bucket order visits candidates differently —
so the engine is gated on measured connectivity, not byte equality
(tests/test_partition_invariants.py).
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.hypergraph import Hypergraph

BIG_NET = 96  # pins; nets above this are skipped in clustering/gain updates
DEG_CAP = 2500  # vertices in more nets than this are not FM move candidates
MAX_PASSES = 2
STALL_MOVES = 100  # hill-descent cutoff: stop after this many non-improving moves


def gather_pins(
    net_ptr: np.ndarray, net_pins: np.ndarray, nets: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Concatenated pins of ``nets`` as one flat gather (CSR index
    arithmetic, no Python per-net loop).  Returns (pins, per_net_counts)."""
    rep = net_ptr[nets + 1] - net_ptr[nets]
    total = int(rep.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), rep
    off = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(rep) - rep, rep)
    pins = net_pins[np.repeat(net_ptr[nets], rep) + off]
    return pins, rep


def compute_counts(hg: Hypergraph, side: np.ndarray) -> np.ndarray:
    """(n_nets, 2) per-side pin counts (one bincount over the pin list)."""
    cnt = np.empty((hg.n_nets, 2), dtype=np.int64)
    cnt[:, 1] = np.bincount(
        hg.pin_nets(), weights=side[hg.net_pins], minlength=hg.n_nets
    )
    cnt[:, 0] = hg.net_sizes() - cnt[:, 1]
    return cnt


def gains_for_all(hg: Hypergraph, side: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """Vectorized FM gains for all vertices via two fused sparse matvecs:
    gain(v) = sum_{n in v} c(n)[cnt(n, side(v)) == 1] - c(n)[cnt(n, other) == 0]."""
    inc = hg.incidence()
    cost = hg.net_cost
    # per-net gain contribution, assuming the vertex sits on side 0 resp. 1
    as0 = inc.T @ (cost * ((cnt[:, 0] == 1).astype(np.int64) - (cnt[:, 1] == 0)))
    as1 = inc.T @ (cost * ((cnt[:, 1] == 1).astype(np.int64) - (cnt[:, 0] == 0)))
    return np.where(side.astype(bool), as1, as0).astype(np.int64)


def fm_refine(
    hg: Hypergraph,
    side: np.ndarray,
    max_w: tuple[float, float],
    max_passes: int = MAX_PASSES,
    cand_cap: int = 1200,
) -> np.ndarray:
    """Boundary FM with gain buckets and an incrementally maintained count
    table.

    Pass setup (counts, gains, boundary detection) is vectorized; the move
    loop itself runs over flat pre-sliced adjacency lists so a move costs
    O(deg) scalar work with no numpy-call overhead.  Gain-increase updates
    push eagerly; decreases are re-keyed lazily when the stale bucket entry
    surfaces.  Deterministic: ties break by bucket LIFO order, which is
    fixed by the candidate enumeration order."""
    n = hg.n_vertices
    if n == 0 or hg.n_nets == 0:
        return side.astype(np.int8)
    vptr, vnets = hg.vertex_to_nets()
    net_ptr = hg.net_ptr
    net_pins = hg.net_pins
    small = hg.net_sizes() <= BIG_NET
    wf = hg.w_comp.astype(np.float64)
    side = side.astype(np.int8).copy()
    cnt = compute_counts(hg, side)
    deg = np.diff(vptr)
    pin_nets = hg.pin_nets()

    # flat adjacency as plain lists, sliced lazily per touched vertex/net
    vl = vnets.tolist()
    vp = vptr.tolist()
    pl = net_pins.tolist()
    npt = net_ptr.tolist()
    small_l = small.tolist()
    cost_l = hg.net_cost.tolist()
    wf_l = wf.tolist()
    cnt0 = cnt[:, 0].tolist()
    cnt1 = cnt[:, 1].tolist()
    side_l = side.tolist()
    side_w = [float(wf[side == 0].sum()), float(wf[side == 1].sum())]
    caps = (float(max_w[0]), float(max_w[1]))

    for _pass in range(max_passes):
        cnt = np.stack(
            [np.asarray(cnt0, dtype=np.int64), np.asarray(cnt1, dtype=np.int64)], axis=1
        )
        side = np.asarray(side_l, dtype=np.int8)
        cut = (cnt[:, 0] > 0) & (cnt[:, 1] > 0)
        if not cut.any():
            break
        boundary = np.zeros(n, dtype=bool)
        boundary[net_pins[cut[pin_nets]]] = True
        cand = np.flatnonzero(boundary & (deg <= DEG_CAP))
        if len(cand) == 0:
            break
        gains = gains_for_all(hg, side, cnt)
        if len(cand) > cand_cap:
            top = np.argsort(-gains[cand], kind="stable")[:cand_cap]
            cand = cand[top]
        g_l = gains.tolist()
        in_cand = bytearray(n)
        locked = bytearray(n)
        for u in cand.tolist():
            in_cand[u] = 1

        # gain buckets: candidates listed per distinct integer gain, plus a
        # lazy max-key heap over bucket keys.  push is O(1); pop-max is O(1)
        # amortized (stale keys and entries are discarded lazily on pop).
        buckets: dict[int, list[int]] = {}
        keyheap: list[int] = []
        heappush, heappop = heapq.heappush, heapq.heappop

        def push(u: int, gu: int) -> None:
            b = buckets.get(gu)
            if b is None:
                buckets[gu] = [u]
                heappush(keyheap, -gu)
            else:
                b.append(u)

        for u in cand.tolist():
            push(u, g_l[u])
        deferred: tuple[list[int], list[int]] = ([], [])
        low_water = [float("inf"), float("inf")]

        history: list[int] = []
        cum = best_cum = 0
        best_idx = -1
        while True:
            # --- O(1) amortized best feasible move ---------------------
            v = -1
            while keyheap:
                key = -keyheap[0]
                b = buckets.get(key)
                if not b:
                    heappop(keyheap)
                    if b is not None:
                        del buckets[key]
                    continue
                u = b.pop()
                if locked[u]:
                    continue
                gu = g_l[u]
                if gu != key:
                    if gu < key:
                        push(u, gu)  # lazily re-key a decreased gain
                    continue  # an eager push already covers increases
                t = 1 - side_l[u]
                if side_w[t] + wf_l[u] > caps[t]:
                    # parked until side t has strictly more headroom than
                    # at any deferral since the last flush
                    deferred[t].append(u)
                    if side_w[t] < low_water[t]:
                        low_water[t] = side_w[t]
                    continue
                v = u
                break
            if v < 0:
                break
            s = side_l[v]
            t = 1 - s
            # --- apply move: O(deg) flat scalar delta-gain updates -----
            src, dst = (cnt0, cnt1) if s == 0 else (cnt1, cnt0)
            for nid in vl[vp[v] : vp[v + 1]]:
                cs = src[nid]
                ct = dst[nid]
                src[nid] = cs - 1
                dst[nid] = ct + 1
                if not small_l[nid]:
                    continue
                c = cost_l[nid]
                # rule 1: t-count was 0 -> every other pin gains +c
                # rule 2: t-count was 1 -> the lone t-side pin gains -c
                # rule 3: s-count now 0 -> every other pin gains -c
                # rule 4: s-count now 1 -> the lone s-side pin gains +c
                d_all = (c if ct == 0 else 0) - (c if cs == 1 else 0)
                d_s = c if cs == 2 else 0
                d_t = -c if ct == 1 else 0
                if d_all or d_s or d_t:
                    for u in pl[npt[nid] : npt[nid + 1]]:
                        if u == v or locked[u] or not in_cand[u]:
                            continue
                        d = d_all + (d_s if side_l[u] == s else d_t)
                        if d:
                            gu = g_l[u] + d
                            g_l[u] = gu
                            if d > 0:
                                push(u, gu)
            side_l[v] = t
            side_w[s] -= wf_l[v]
            side_w[t] += wf_l[v]
            locked[v] = 1
            if deferred[s] and side_w[s] < low_water[s]:
                for u in deferred[s]:
                    push(u, g_l[u])
                deferred[s].clear()
                low_water[s] = float("inf")
            history.append(v)
            cum += key
            if cum > best_cum:
                best_cum, best_idx = cum, len(history) - 1
            elif key < 0 and len(history) - 1 - best_idx > STALL_MOVES:
                break
        # --- rollback to best prefix, keeping counts consistent --------
        for v in reversed(history[best_idx + 1 :]):
            t = side_l[v]
            s = 1 - t
            src, dst = (cnt0, cnt1) if t == 0 else (cnt1, cnt0)
            for nid in vl[vp[v] : vp[v + 1]]:
                src[nid] -= 1
                dst[nid] += 1
            side_l[v] = s
            side_w[t] -= wf_l[v]
            side_w[s] += wf_l[v]
        if best_cum <= 0:
            break
    return np.asarray(side_l, dtype=np.int8)


def initial_bisect(
    hg: Hypergraph,
    target0: float,
    rng: np.random.Generator,
    min0: float = 0.0,
) -> np.ndarray:
    """Greedy net-BFS growth of side 0 up to ~``target0`` compute weight,
    one whole frontier level per step (vectorized).  The level that crosses
    the target is cut at the weight prefix.

    ``min0`` is the feasibility floor: below it heavy crossing vertices are
    taken even past the 5% slack, so side 1 (which gets the complement)
    cannot be left over its balance cap by an under-grown side 0."""
    n = hg.n_vertices
    side = np.ones(n, dtype=np.int8)
    if n == 0 or target0 <= 0:
        return side
    vptr, vnets = hg.vertex_to_nets()
    net_ptr, net_pins = hg.net_ptr, hg.net_pins
    w = hg.w_comp.astype(np.float64)
    seen = np.zeros(n, dtype=bool)
    net_seen = np.zeros(hg.n_nets, dtype=bool)
    frontier = np.array([int(rng.integers(n))], dtype=np.int64)
    seen[frontier] = True
    total0 = 0.0
    while total0 < target0:
        if len(frontier) == 0:
            rest = np.flatnonzero(~seen)
            if len(rest) == 0:
                break
            frontier = np.array([int(rest[rng.integers(len(rest))])], dtype=np.int64)
            seen[frontier] = True
        cw = np.cumsum(w[frontier])
        k = int(np.searchsorted(cw, target0 - total0, side="right"))
        if k:
            side[frontier[:k]] = 0
            total0 += float(cw[k - 1])
        if k < len(frontier):
            # crossing vertex: take it only within the 5% slack (matching
            # the loop reference) — or unconditionally while still under
            # the feasibility floor — then keep scanning the level
            v0 = int(frontier[k])
            if (
                total0 == 0.0
                or total0 < min0
                or total0 + w[v0] <= target0 * 1.05
            ):
                side[v0] = 0
                total0 += w[v0]
            frontier = frontier[k + 1 :]
            continue
        # level exhausted below target: expand unvisited nets, unseen pins
        nets, _ = gather_pins(vptr, vnets, frontier)
        nets = nets[~net_seen[nets]]
        if len(nets):
            nets = np.unique(nets)
            net_seen[nets] = True
        pins, _ = gather_pins(net_ptr, net_pins, nets)
        pins = pins[~seen[pins]]
        pins = np.unique(pins)
        seen[pins] = True
        frontier = pins
    return side


def kway_refine(
    hg: Hypergraph,
    parts: np.ndarray,
    p: int,
    part_cap: float,
    max_rounds: int = 5,
    dense_cell_cap: int = 25_000_000,
) -> np.ndarray:
    """Direct K-way refinement: greedy boundary label propagation over all
    p parts minimizing sum_n c(n)·(lambda(n)-1) under the Def. 4.4 cap.

    Each round scores every vertex's best target part with two vectorized
    passes (leave-gain via a bincount over pins, arrival penalty via one
    sparse·dense matvec), then applies candidate moves in descending-gain
    order, re-validating each against the live count table — so applied
    moves are individually improving and balance-feasible.

    When the dense (n_nets, p) count table would exceed ``dense_cell_cap``
    cells (paper-scale fine models at large p), refinement switches to
    ``_kway_refine_restricted``, which tracks only the round's cut nets and
    scores only boundary vertices — exact at round start and conservative
    within a round, so monotonicity still holds.
    """
    if p <= 1 or hg.n_nets == 0 or hg.n_vertices == 0 or hg.n_pins == 0:
        return parts
    if hg.n_nets * p > dense_cell_cap:
        return _kway_refine_restricted(hg, parts, p, part_cap, max_rounds)
    parts = parts.astype(np.int64).copy()
    n = hg.n_vertices
    net_pins = hg.net_pins
    pin_nets = hg.pin_nets()
    vptr, vnets = hg.vertex_to_nets()
    cost = hg.net_cost
    wf = hg.w_comp.astype(np.float64)
    part_w = np.bincount(parts, weights=wf, minlength=p)
    # int32 counts / float32 costs keep the dense table and each round's
    # arrival temp at 4 bytes per cell near the dense_cell_cap boundary
    cnt = (
        np.bincount(pin_nets * p + parts[net_pins], minlength=hg.n_nets * p)
        .reshape(hg.n_nets, p)
        .astype(np.int32)
    )
    cost32 = cost.astype(np.float32)
    inc = hg.incidence()
    rows = np.arange(n)
    first_improved = None
    # flat scalar mirrors for the apply loop (kept in sync with cnt/parts)
    cnt_l = cnt.tolist()
    parts_l = parts.tolist()
    part_w_l = part_w.tolist()
    wf_l = wf.tolist()
    cost_l = cost.tolist()
    vl = vnets.tolist()
    vp = vptr.tolist()
    for _round in range(max_rounds):
        at_own = cnt[pin_nets, parts[net_pins]]
        g_leave = np.bincount(
            net_pins, weights=cost[pin_nets] * (at_own == 1), minlength=n
        )
        arrive = inc.T @ (cost32[:, None] * (cnt == 0))  # (n, p) float32
        gain = g_leave.astype(np.float32)[:, None] - arrive
        gain[part_w[None, :] + wf[:, None] > part_cap] = -np.inf
        gain[rows, parts] = -np.inf
        best_t = np.argmax(gain, axis=1)
        best_g = gain[rows, best_t]
        movers = np.flatnonzero(best_g > 0)
        # drain mode: vertices of parts over the cap may move at zero or
        # negative gain (least damage first) until their part fits again —
        # this restores eps-feasibility lost to lumpy coarse vertices
        over = part_w > part_cap
        if over.any():
            drains = np.flatnonzero(
                over[parts] & np.isfinite(best_g) & (best_g <= 0)
            )
            movers = np.concatenate([movers, drains])
        if len(movers) == 0:
            break
        order = movers[np.argsort(-best_g[movers], kind="stable")]
        improved = 0
        applied: list[int] = []
        applied_s: list[int] = []
        applied_t: list[int] = []
        for v, t in zip(order.tolist(), best_t[order].tolist()):
            s = parts_l[v]
            wv = wf_l[v]
            if part_w_l[t] + wv > part_cap:
                continue
            nets = vl[vp[v] : vp[v + 1]]
            g_exact = 0
            for nid in nets:  # re-validate against the live count table
                row = cnt_l[nid]
                if row[s] == 1:
                    g_exact += cost_l[nid]
                if row[t] == 0:
                    g_exact -= cost_l[nid]
            if g_exact <= 0 and part_w_l[s] <= part_cap:
                continue  # negative-gain moves only drain overfull parts
            for nid in nets:
                row = cnt_l[nid]
                row[s] -= 1
                row[t] += 1
            parts_l[v] = t
            part_w_l[s] -= wv
            part_w_l[t] += wv
            improved += g_exact
            applied.append(v)
            applied_s.append(s)
            applied_t.append(t)
        if not applied:
            break
        if first_improved is None:
            first_improved = max(improved, 1)
        # resync the numpy mirrors from the applied-move log (vectorized)
        mv = np.array(applied, dtype=np.int64)
        mv_t = np.array(applied_t, dtype=np.int64)
        parts[mv] = mv_t
        nets_cat, rep = gather_pins(vptr, vnets, mv)
        # flat bincount deltas instead of np.add.at: add.at is numpy's
        # slowest scatter idiom (unbuffered per-element dispatch), while one
        # bincount over linearized (net, part) indices is a single C pass
        flat = nets_cat * p
        dec = np.bincount(
            flat + np.repeat(np.array(applied_s, dtype=np.int64), rep),
            minlength=hg.n_nets * p,
        )
        inc2 = np.bincount(flat + np.repeat(mv_t, rep), minlength=hg.n_nets * p)
        cnt += (inc2 - dec).reshape(hg.n_nets, p).astype(np.int32)
        part_w = np.asarray(part_w_l)
        if improved < 0.05 * first_improved and not (part_w > part_cap).any():
            break  # converged: late rounds buy <5% of the first round's gain
    return parts


def _kway_refine_restricted(
    hg: Hypergraph,
    parts: np.ndarray,
    p: int,
    part_cap: float,
    max_rounds: int,
) -> np.ndarray:
    """K-way refinement for instances where the dense (n_nets, p) table
    would not fit: per round, only the currently *cut* nets get a count
    table and only boundary vertices are scored.

    A vertex's untracked nets were internal to its own part at round start,
    so they contribute no leave-gain and a flat arrival penalty of their
    summed cost — exact at round start.  Within a round the untracked terms
    can only underestimate a move's true gain (another mover may have made
    the net cut, or populated the target side), so every applied
    positive-gain move is still a true improvement: monotone, like the
    dense mode.  Drains (negative-gain moves out of over-cap parts) only
    consider boundary vertices here.
    """
    import scipy.sparse as sp

    parts = parts.astype(np.int64).copy()
    n = hg.n_vertices
    net_ptr, net_pins = hg.net_ptr, hg.net_pins
    pin_nets = hg.pin_nets()
    vptr, vnets = hg.vertex_to_nets()
    cost = hg.net_cost
    wf = hg.w_comp.astype(np.float64)
    part_w = np.bincount(parts, weights=wf, minlength=p)
    s_all = np.asarray(hg.incidence().T @ cost).ravel()  # static incident cost
    vl = vnets.tolist()
    vp = vptr.tolist()
    wf_l = wf.tolist()
    cost_l = cost.tolist()
    first_improved = None
    seg = np.minimum(net_ptr[:-1], max(hg.n_pins - 1, 0))  # guard empty nets
    for _round in range(max_rounds):
        pin_parts = parts[net_pins]
        cut = np.maximum.reduceat(pin_parts, seg) != np.minimum.reduceat(
            pin_parts, seg
        )
        cut_ids = np.flatnonzero(cut)
        m = len(cut_ids)
        if m == 0:
            break
        tid = np.full(hg.n_nets, -1, dtype=np.int64)
        tid[cut_ids] = np.arange(m)
        tmask = cut[pin_nets]
        t_pins = net_pins[tmask]
        t_nets = tid[pin_nets[tmask]]
        cost_cut = cost[cut_ids]
        cnt = np.bincount(t_nets * p + parts[t_pins], minlength=m * p).reshape(m, p)
        bnd = np.unique(t_pins)
        posB = np.full(n, -1, dtype=np.int64)
        posB[bnd] = np.arange(len(bnd))
        at_own = cnt[t_nets, parts[t_pins]]
        g_leave = np.bincount(
            t_pins, weights=cost[pin_nets[tmask]] * (at_own == 1), minlength=n
        )[bnd]
        incB = sp.csr_matrix(
            (np.ones(len(t_pins), dtype=np.int8), (posB[t_pins], t_nets)),
            shape=(len(bnd), m),
        )
        arrive = incB @ (cost_cut[:, None] * (cnt == 0))
        pen_int = s_all[bnd] - incB @ cost_cut  # untracked = internal nets
        gain = g_leave[:, None] - arrive - pen_int[:, None]
        wb = wf[bnd]
        gain[part_w[None, :] + wb[:, None] > part_cap] = -np.inf
        brows = np.arange(len(bnd))
        gain[brows, parts[bnd]] = -np.inf
        best_t = np.argmax(gain, axis=1)
        best_g = gain[brows, best_t]
        movers = np.flatnonzero(best_g > 0)
        over = part_w > part_cap
        if over.any():
            drains = np.flatnonzero(
                over[parts[bnd]] & np.isfinite(best_g) & (best_g <= 0)
            )
            movers = np.concatenate([movers, drains])
        if len(movers) == 0:
            break
        order = movers[np.argsort(-best_g[movers], kind="stable")]
        tid_l = tid.tolist()
        cnt_l = cnt.tolist()
        parts_l: dict[int, int] = {}  # only moved vertices change
        part_w_l = part_w.tolist()
        improved = 0
        applied: list[int] = []
        applied_t: list[int] = []
        for b, t in zip(bnd[order].tolist(), best_t[order].tolist()):
            v = b
            s = parts_l.get(v, -1)
            if s < 0:
                s = int(parts[v])
            if s == t:
                continue
            wv = wf_l[v]
            if part_w_l[t] + wv > part_cap:
                continue
            nets = vl[vp[v] : vp[v + 1]]
            g_exact = 0
            for nid in nets:
                k = tid_l[nid]
                if k >= 0:
                    row = cnt_l[k]
                    if row[s] == 1:
                        g_exact += cost_l[nid]
                    if row[t] == 0:
                        g_exact -= cost_l[nid]
                else:
                    # untracked: internal to s at round start — no leave
                    # gain, conservative arrival penalty
                    g_exact -= cost_l[nid]
            if g_exact <= 0 and part_w_l[s] <= part_cap:
                continue
            for nid in nets:
                k = tid_l[nid]
                if k >= 0:
                    row = cnt_l[k]
                    row[s] -= 1
                    row[t] += 1
            parts_l[v] = t
            part_w_l[s] -= wv
            part_w_l[t] += wv
            improved += g_exact
            applied.append(v)
            applied_t.append(t)
        if not applied:
            break
        if first_improved is None:
            first_improved = max(improved, 1)
        parts[np.array(applied, dtype=np.int64)] = np.array(applied_t, dtype=np.int64)
        part_w = np.asarray(part_w_l)
        if improved < 0.05 * first_improved and not (part_w > part_cap).any():
            break
    return parts
