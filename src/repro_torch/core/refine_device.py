"""Device-side K-way refinement: batched multi-seed label propagation in torch.

The port of ``repro.core.refine_device`` — the refinement half of
``partition(engine="device")`` (DESIGN.md §6).  The reference is one jitted
XLA kernel per level, ``vmap``-ed over the multi-start batch; here the same
rounds are plain PyTorch ops on an explicit device, with the seed batch as a
leading dimension and a Python loop over the rounds.  Given the same
padded level, starts and salts, the labels and scores equal the reference's
wherever the reference's sums are exact (every test size).

What each round does (the reference's algorithm, unchanged):

- **Sampled-candidate moves, exact gains.**  Each vertex draws one
  candidate label per round by walking vertex → random incident net →
  random pin → its part (counter-based hashing, no RNG state), and the exact
  connectivity delta of that single move is a segment sum over the
  vertex-CSR ordering of the pins.
- **Balance as stochastic headroom thinning**, then an exact capacity guard:
  arrivals toward one part are admitted greedily in vertex order while a
  per-target running prefix stays under the part's headroom.  A per-round
  best-feasible snapshot ((connectivity, cap-feasibility) score) makes the
  returned partition monotone.

Where the port differs from the reference, and why:

- **Counts by scatter.**  The reference builds its ``(nets, p)`` count table
  from lane-packed int32 cumsums because XLA's CPU scatter is slow; an
  integer scatter-add is exact on the card and the CPU alike, so the port
  counts with one.  The ``MAX_DEVICE_NET`` / ``LANE_NET_CAP`` filters of
  ``_pad_level`` stay: they decide which nets the device view sees.
- **Exact prefix sums.**  The reference's float32 cumsums (the gains, the
  guard's running prefix) and float32 reductions (part weights, inflow,
  connectivity) are exact only while every partial sum stays below 2^24.
  The port sums those integer-valued terms in float64 (exact far past
  that), then rounds once where the reference hands the value to a float32
  operation.  So the port equals the reference wherever the reference is
  exact, and the card's labels equal the CPU's at any size; past 2^24 the
  reference rounds in sequence and the port does not.
- **The uint32 hash** runs in int64 with every product masked to its low 32
  bits (the high half of the multiplier is folded in separately, so no
  product leaves int64), bit for bit the reference's ``_hash_u32``.
- **Gathers clamp** their indices to the array, as XLA's do; the clamped
  values are always masked out.
- **No retrace counter.**  Eager torch compiles nothing per shape, so the
  reference's ``trace_count()`` has no counterpart.  The shape buckets and
  the phantom vertex and net stay all the same: they decide the padded
  shapes, and with them where the coarsening descent stops.
- **No host sync inside a round**: no ``.item()``, no boolean-mask indexing,
  no ``bincount`` (which sizes its output on the host).

The driver applies the refiner at every V-cycle level, then hands the best
seed to one host ``kway_refine`` polish (the exactness authority: it also
sees the big nets the device view filters out).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.hypergraph import Hypergraph

__all__ = [
    "DEVICE_STARTS",
    "ROUNDS_COARSE",
    "ROUNDS_MID",
    "ROUNDS_FINE",
    "initial_partitions",
    "initial_partitions_raw",
    "refine_args",
    "refine_batch",
]

DEVICE_STARTS = 8  # multi-seed batch width (the leading batch axis)
ROUNDS_COARSE = 8  # LP rounds at the coarsest level (cheapest pins)
ROUNDS_MID = 4  # rounds at intermediate levels
ROUNDS_FINE = 2  # rounds at the finest level (the host polish follows)
MAX_DEVICE_NET = 64  # nets bigger than this are excluded from the device view
LANE_NET_CAP = 255  # the reference's 8-bit lane bound on net size (kept)
_BUCKET_MIN = 256  # smallest pad bucket; buckets grow ×1.5
_U32 = 0xFFFFFFFF
_INFEASIBLE = float(np.float32(1e12))  # the score penalty of an over-cap batch


def _bucket(x: int) -> int:
    b = _BUCKET_MIN
    while b < x:
        b = int(b * 1.5) + 1
    return b


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` holding uint32 values: the high
    16 bits of x contribute only the low 16 bits of their product, shifted,
    so no intermediate passes 2^49."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _U32


def _hash_u32(x: torch.Tensor, salt) -> torch.Tensor:
    """Counter-based avalanche hash (splitmix-style), bit for bit the
    reference's uint32 ``_hash_u32`` on int64 tensors of uint32 values;
    ``salt`` is an int or an int64 tensor that broadcasts against ``x``."""
    x = _mul_u32(x ^ salt, 0x9E3779B1)
    x = _mul_u32(x ^ (x >> 15), 0x85EBCA77)
    return x ^ (x >> 13)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with indices clamped into ``x`` (XLA's gather semantics)."""
    return x[idx.clamp(0, x.shape[0] - 1)]


# -- padded flat-CSR level view ----------------------------------------------
@dataclass
class _PaddedLevel:
    nb: int  # vertex bucket (includes 1 phantom vertex)
    mb: int  # net bucket (includes 1 phantom net)
    pb: int  # pin bucket
    args: tuple  # device tensors handed to the refiner
    vinv: object = None  # (pb,) inverse of vperm (used by coarsen_device)


def _kept_nets(sizes: np.ndarray, max_net: int = MAX_DEVICE_NET) -> np.ndarray:
    """The nets the device view keeps: non-empty, within the big-net filter
    and within the lane cap (part of the result: they decide which nets the
    refiner and the coarsener see)."""
    return (sizes >= 1) & (sizes <= min(max_net, LANE_NET_CAP))


def _pad_level(
    hg: Hypergraph, max_net: int = MAX_DEVICE_NET, bucket=None, device="cpu"
) -> _PaddedLevel:
    """Big-net-filtered, bucket-padded device view of one level: the
    reference's 13 arrays, equal value for value (index arrays int64, net
    costs and vertex weights float32, the three ``l*z`` masks bool).

    ``bucket`` overrides the shape-bucket function (default: the ×1.5
    ladder ``_bucket``; the device-resident V-cycle passes its tighter
    quantizer).  Cached on the hypergraph object per (bucket function,
    device)."""
    device = torch.device(device)
    key = (max_net, getattr(bucket, "__name__", "_bucket"), str(device))
    cache = getattr(hg, "_device_pad", None)
    if cache is not None and key in cache:
        return cache[key]
    if bucket is None:
        bucket = _bucket
    sizes = hg.net_sizes()
    keep = _kept_nets(sizes, max_net)
    kn = np.flatnonzero(keep)
    kept_sizes = sizes[kn]
    net_ptr = np.concatenate([[0], np.cumsum(kept_sizes)]).astype(np.int64)
    net_pins_f = hg.net_pins[np.repeat(keep, sizes)]
    npins_f = len(net_pins_f)
    n, m = hg.n_vertices + 1, len(kn) + 1  # + phantom vertex / net
    nb, mb, pb = bucket(n), bucket(m), bucket(max(npins_f, 1))
    pin_nets_f = np.repeat(np.arange(len(kn), dtype=np.int64), kept_sizes)

    pin_nets = np.full(pb, mb - 1, np.int64)
    pin_nets[:npins_f] = pin_nets_f
    net_pins = np.full(pb, nb - 1, np.int64)
    net_pins[:npins_f] = net_pins_f
    cost = np.zeros(mb, np.float32)
    cost[: len(kn)] = hg.net_cost[kn]
    w = np.zeros(nb, np.float32)
    w[: hg.n_vertices] = hg.w_comp

    # per-net pin-range boundaries over the padded pin axis; phantom nets
    # collapse to an empty [pb-1, pb-1] range (segment sum 0)
    hi = np.full(mb, pb - 1, np.int64)
    lo = np.full(mb, pb - 1, np.int64)
    lz = np.zeros(mb, bool)
    hi[: len(kn)] = net_ptr[1:] - 1
    lo[: len(kn)] = net_ptr[:-1] - 1
    lz[: len(kn)] = net_ptr[:-1] == 0

    # vertex-CSR over the SAME filtered pin list: a static permutation maps
    # net-ordered per-pin values into vertex order for the gain segment sums
    order = np.argsort(net_pins_f, kind="stable")
    vperm = np.arange(pb, dtype=np.int64)
    vperm[:npins_f] = order
    vdeg_np = np.bincount(net_pins_f, minlength=n)
    vp = np.concatenate([[0], np.cumsum(vdeg_np)]).astype(np.int64)
    vhi = np.full(nb, pb - 1, np.int64)
    vlo = np.full(nb, pb - 1, np.int64)
    vlz = np.zeros(nb, bool)
    vhi[:n] = vp[1:] - 1
    vlo[:n] = vp[:-1] - 1
    vlz[:n] = vp[:-1] == 0
    vptr = np.zeros(nb + 1, np.int64)
    vptr[: n + 1] = vp
    vptr[n + 1 :] = vp[-1]
    vnets = np.full(pb, mb - 1, np.int64)
    vnets[:npins_f] = pin_nets_f[order]
    # inverse of vperm: vertex-order position of each net-order slot; the
    # coarsening step uses it to transport per-leader budgets to net slots
    vinv = np.empty(pb, np.int64)
    vinv[vperm] = np.arange(pb, dtype=np.int64)

    def T(x):
        return torch.as_tensor(x, device=device)

    pl = _PaddedLevel(
        nb=nb,
        mb=mb,
        pb=pb,
        vinv=T(vinv),
        args=tuple(
            T(x) for x in (pin_nets, net_pins, cost, w, vptr, vnets, vperm, hi, lo, lz,
                           vhi, vlo, vlz)
        ),
    )
    try:
        if cache is None:
            hg._device_pad = cache = {}
        cache[key] = pl
    except AttributeError:  # exotic containers without a __dict__
        pass
    return pl


# -- the refiner --------------------------------------------------------------
def _group_prefix(key: torch.Tensor, x: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Inclusive prefix sums of ``x`` within groups of equal ``key`` (1-D,
    keys in [0, n_groups)), each group summed in index order — the
    reference's per-target running prefix, without its (n, groups) table."""
    order = torch.sort(key, stable=True).indices
    xs = x[order]
    cs = torch.cumsum(xs, 0)
    counts = torch.zeros(n_groups, dtype=torch.int64, device=key.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    start = torch.cumsum(counts, 0) - counts  # first sorted position of a group
    before = torch.cat([cs.new_zeros(1), cs])[start]  # cs just before it
    out = torch.empty_like(x)
    out[order] = cs - before[key[order]]
    return out


def _refine(parts0, args, p: int, cap: float, rounds: int, salts):
    """The reference's ``_make_refiner`` body over a (starts, nb) batch:
    returns the per-start best-feasible partitions (int64) and their
    float32 scores, on the batch's device."""
    (pin_nets, net_pins, cost, w, vptr, vnets, vperm, hi, lo, lo_zero,
     vhi, vlo, vlo_zero) = args
    starts, nb = parts0.shape
    mb, pb = cost.shape[0], pin_nets.shape[0]
    dev = parts0.device
    cap32 = float(np.float32(cap))  # the reference's float32 cap, exactly
    cost64 = cost.double()
    cost_pin = cost64[pin_nets]
    w64 = w.double().expand(starts, nb)
    vdeg = vptr[1:] - vptr[:-1]
    vids = torch.arange(nb, device=dev)
    net_lo = torch.where(lo_zero, 0, lo + 1)  # per-net first pin slot
    ndeg = hi + 1 - net_lo
    # the pins each net's count covers: its own range (phantom nets have none)
    slot = torch.arange(pb, device=dev)
    in_net = (slot >= net_lo[pin_nets]) & (slot <= hi[pin_nets])
    seed_rows = torch.arange(starts, device=dev)[:, None]
    # a start's count cells: (mb + 1) nets x p parts, the last net a sink
    # for the pins outside their net's range
    cell = (torch.where(in_net, pin_nets, mb) + seed_rows * (mb + 1)) * p
    lo_c, vlo_c = lo.clamp(min=0), vlo.clamp(min=0)
    salts = salts[:, None]

    def gather(x, idx):  # per-start gather along the vertex/part axis
        return torch.gather(x, 1, idx)

    def counts(parts):
        """(starts, mb, p) per-net per-part pin counts, by integer scatter."""
        key = cell + gather(parts, net_pins.expand(starts, pb))
        cnt = torch.zeros(starts * (mb + 1) * p, dtype=torch.int64, device=dev)
        cnt.scatter_add_(0, key.reshape(-1), torch.ones_like(key).reshape(-1))
        return cnt.view(starts, mb + 1, p)[:, :mb]

    def part_weights(parts):
        return torch.zeros(starts, p, dtype=torch.float64, device=dev).scatter_add_(
            1, parts, w64
        )

    def score_of(cnt, part_w):
        lam = (cnt > 0).sum(2)
        conn = (cost64 * (lam - 1).clamp(min=0)).sum(1)
        # any over-cap part makes the score worse than every feasible one —
        # the snapshot then prefers feasibility over cut (float32 as the
        # reference: the penalty swamps the cut)
        return conn.float() + (part_w.max(1).values > cap32).float() * _INFEASIBLE

    def body(i, parts, part_w, best_parts, best_sc):
        cnt = counts(parts)
        sc = score_of(cnt, part_w)
        better = sc < best_sc
        best_parts = torch.where(better[:, None], parts, best_parts)
        best_sc = torch.where(better, sc, best_sc)
        # candidate label: vertex -> random incident net -> random pin of
        # that net -> its current part
        h1 = _hash_u32(vids, salts ^ ((i * 0x85EBCA77) & _U32))
        e = _take(vnets, vptr[:nb] + h1 % vdeg.clamp(min=1))
        h2 = _hash_u32(h1, salts ^ 0xC2B2AE35)
        u = _take(net_pins, _take(net_lo, e) + h2 % _take(ndeg, e).clamp(min=1))
        cand = torch.where(vdeg > 0, gather(parts, u), parts)
        # exact connectivity delta of each single move v -> cand(v): per-pin
        # leave/arrive terms, segment-summed in vertex order
        cnt_flat = cnt.reshape(starts, mb * p)
        own_pin = gather(parts, net_pins.expand(starts, pb))
        cand_pin = gather(cand, net_pins.expand(starts, pb))
        leave = cost_pin * (gather(cnt_flat, pin_nets * p + own_pin) == 1)
        arrive = cost_pin * (gather(cnt_flat, pin_nets * p + cand_pin) == 0)
        csv = torch.cumsum((leave - arrive)[:, vperm], 1)
        gain = csv[:, vhi] - torch.where(vlo_zero, 0.0, csv[:, vlo_c])
        over = part_w > cap32
        want = (cand != parts) & ((gain > 0) | gather(over, parts))
        # balance: thin simultaneous arrivals to the headroom (float32 as
        # the reference, on exactly summed weights)
        inflow = torch.zeros_like(part_w).scatter_add_(1, cand, torch.where(want, w64, 0.0))
        headroom = (cap32 - part_w.float()).clamp(min=0.0)
        acc = (gather(headroom, cand) / gather(inflow.float(), cand).clamp(min=1e-9)).clamp(
            max=1.0
        )
        u01 = (_hash_u32(vids, salts ^ 0x165667B1 ^ i) >> 8).float() / float(1 << 24)
        accept = want & (u01 < acc)
        # exact capacity guard: arrivals admitted greedily in vertex order
        # while the per-target running prefix stays under the headroom
        pre = _group_prefix(
            (seed_rows * p + cand).reshape(-1),
            torch.where(accept, w64, 0.0).reshape(-1),
            starts * p,
        ).view(starts, nb)
        accept = accept & (pre <= gather(headroom, cand).double())
        parts = torch.where(accept, cand, parts)
        return parts, part_weights(parts), best_parts, best_sc

    parts = parts0
    part_w = part_weights(parts)
    best_parts = parts0
    best_sc = torch.full((starts,), float(np.float32(1e30)), dtype=torch.float32, device=dev)
    for i in range(rounds):
        parts, part_w, best_parts, best_sc = body(i, parts, part_w, best_parts, best_sc)
    sc = score_of(counts(parts), part_w)
    better = sc < best_sc
    return torch.where(better[:, None], parts, best_parts), torch.where(better, sc, best_sc)


# -- public entry points ------------------------------------------------------
def initial_partitions_raw(
    w: np.ndarray, p: int, seed: int, starts: int = DEVICE_STARTS
) -> np.ndarray:
    """(starts, len(w)) int32 balanced random partitions over raw vertex
    weights, on the host — the reference's, copied.

    Placement is longest-processing-time greedy (heaviest remaining vertex
    into the lightest part): at a coarse level single clusters weigh a
    sizeable fraction of a part, and chunked binning would overshoot the
    balance cap.  Start diversity comes from a per-seed multiplicative
    jitter on the ordering weights.  The lightest-part pick runs on a heap
    of ``(weight, part)`` tuples, whose order matches ``argmin``'s
    first-minimum tie-break."""
    w = np.asarray(w, dtype=np.float64)
    n = len(w)
    batch = np.zeros((starts, n), np.int32)
    wl = w.tolist()
    for s in range(starts):
        rng = np.random.default_rng((seed, s))
        order = np.argsort(-(w * (1.0 + 0.25 * rng.random(n))), kind="stable")
        heap = [(0.0, t) for t in range(p)]
        row = batch[s]
        for v in order.tolist():
            wt, t = heap[0]
            row[v] = t
            heapq.heapreplace(heap, (wt + wl[v], t))
    return batch


def initial_partitions(
    hg: Hypergraph, p: int, seed: int, starts: int = DEVICE_STARTS
) -> np.ndarray:
    """(starts, n_vertices) int32 balanced random partitions — the batch of
    independent starts the refiner refines side by side."""
    return initial_partitions_raw(hg.w_comp, p, seed, starts)


def refine_args(
    nb: int,
    mb: int,
    pb: int,
    args: tuple,
    parts_b,
    p: int,
    part_cap: float,
    rounds: int,
    seed: int = 0,
    salt: int = 0,
):
    """Refinement on a padded level's raw tensors, on their device.

    ``args`` is the 13-tensor layout of ``_pad_level`` (or a coarse level
    contracted by ``coarsen_device``); ``parts_b`` is an already-padded
    ``(starts, nb)`` batch (numpy or tensor).  The returned ``(batch,
    scores)`` stay on the device — no host round trip between levels."""
    dev = args[0].device
    parts_b = torch.as_tensor(parts_b, device=dev).long()
    starts = parts_b.shape[0]
    if parts_b.shape != (starts, nb) or args[2].shape[0] != mb or args[0].shape[0] != pb:
        raise ValueError(f"a ({starts}, {nb}) batch for level ({nb}, {mb}, {pb}) "
                         f"got {tuple(parts_b.shape)}")
    mix = ((seed * 0x85EBCA77) ^ (salt * 0xC2B2AE35)) & _U32
    # made on the device: no host-to-device copy (a sync) at every level
    salts = ((torch.arange(starts, device=dev) * 0x9E3779B9) & _U32) ^ mix
    return _refine(parts_b, args, p, part_cap, rounds, salts)


def refine_batch(
    hg: Hypergraph,
    parts_batch: np.ndarray,
    p: int,
    part_cap: float,
    rounds: int,
    seed: int = 0,
    salt: int = 0,
    device="cpu",
) -> tuple[np.ndarray, np.ndarray]:
    """Refine a (starts, n_vertices) batch of partitions on ``hg`` for a
    fixed number of LP rounds on ``device``.  Returns (batch, scores) on the
    host: per-seed best-feasible partitions and their float32 scores
    (filtered-net connectivity + a large penalty when over the balance cap)
    — comparable across seeds, so ``argmin`` picks the winner."""
    pl = _pad_level(hg, device=device)
    starts = parts_batch.shape[0]
    padded = np.zeros((starts, pl.nb), np.int64)
    padded[:, : hg.n_vertices] = parts_batch
    bp, bs = refine_args(
        pl.nb, pl.mb, pl.pb, pl.args, padded, p, part_cap, rounds, seed, salt
    )
    return bp[:, : hg.n_vertices].cpu().numpy().astype(np.int32), bs.cpu().numpy()
