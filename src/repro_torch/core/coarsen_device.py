"""Device-side multilevel coarsening: clustering + contraction in torch.

The port of ``repro.core.coarsen_device`` — the descend half of
``partition(engine="device")`` (DESIGN.md §6).  The reference's two jitted
kernels per level (clustering, contraction) are plain PyTorch ops here on an
explicit device, with a Python loop over the merge rounds; the only per-level
host traffic is the same two scalars as the reference's (surviving vertex
and pin counts, which pick the next level's shape buckets), read in one
transfer.  Given the same level, cap, seed and index, the cluster maps and
coarse levels equal the reference's wherever its float32 sums are exact.

The algorithm (the reference's, unchanged):

- **Leader-based clustering.**  Each round every live cluster
  representative draws two incident nets (counter-based hash) and keeps the
  better score ``c(n)/(|n|-1)``; the net's *anchor* (its first pin's
  vertex) is the merge target.  A per-round role hash splits vertices into
  proposers and acceptors, so merges are one-sided and deterministic.
- **Weight-capped grants via segmented prefix sums**: proposals toward a
  net are granted in pin order while the anchor's running cluster weight
  stays under the cap.
- **Labels stay in the fine index space** during the rounds (pointer
  jumping resolves chains at the end); contraction re-ranks the surviving
  representatives.  Nets whose pins collapse into one cluster are dead
  (pins dropped, cost zeroed); within-net duplicate pins are dropped after
  one packed sort, which is what shrinks the pin count down the hierarchy.

Where the port differs: the grant prefixes (``csn``, ``csl``, ``csgl``) and
the coarse weights (``csw``) are float64 sums of integer-valued terms, exact
past 2^24 where the reference's float32 cumsums round; the grant cutoff is
still computed from the float32 values the reference forms.  The sort keys
are int64 here, but the reference's int32 packing guard (``_INT31``) stays:
it decides where the descent stops, so it is part of the result.
``packs_finest`` reads that guard for a hypergraph's finest level without
building it, so the driver's ``coarsen="auto"`` can tell beforehand that
the resident descent would not take its first step.  The
reference's ``trace_count()`` has no counterpart (eager torch traces
nothing).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import refine_device as _rd
from repro_torch.core.hypergraph import Hypergraph
from repro_torch.core.refine_device import _U32, _hash_u32, _take

__all__ = [
    "CLUSTER_ROUNDS",
    "MAX_LEVELS",
    "DeviceLevel",
    "finest_level",
    "packs_finest",
    "coarsen_level",
]

CLUSTER_ROUNDS = 5  # merge rounds per level
MAX_LEVELS = 12  # hard stop on V-cycle depth
STALL_FRACTION = 0.8  # stop descending when a level keeps >= this many vertices
_INT31 = 1 << 31  # the reference's int32 packing bound for its sort keys
_KEY_PAD = _INT31 - 1  # the reference's sort-key padding, above every packed key


def _bucket_fine(x: int) -> int:
    """Coarse-level shape bucket: ceil to a 512 multiple instead of the
    finest level's ×1.5 geometric ladder (waste under 1% at realistic
    coarse sizes)."""
    return max(_rd._BUCKET_MIN, -(-x // 512) * 512)


@dataclass
class DeviceLevel:
    """One V-cycle level resident on a device: the 13-tensor padded layout
    of ``refine_device._pad_level`` (consumable by ``refine_args``
    directly) plus the inverse pin permutation the clustering needs."""

    nb: int  # vertex bucket (includes 1 phantom vertex)
    mb: int  # net bucket (kept constant down the hierarchy; dead nets empty)
    pb: int  # pin bucket
    n_vertices: int  # live vertices (unpadded)
    args: tuple  # (pin_nets, net_pins, cost, w, vptr, vnets, vperm,
    #              hi, lo, lz, vhi, vlo, vlz)
    vinv: object  # (pb,) vertex-order position of each net-order pin slot


def finest_level(hg: Hypergraph, device="cpu") -> DeviceLevel:
    """Wrap the (cached) finest padded view as the root device level, padded
    with the tight quantizer rather than the refiner's ×1.5 ladder."""
    pl = _rd._pad_level(hg, bucket=_bucket_fine, device=device)
    return DeviceLevel(
        nb=pl.nb,
        mb=pl.mb,
        pb=pl.pb,
        n_vertices=hg.n_vertices,
        args=pl.args,
        vinv=pl.vinv,
    )


def _packs(nb: int, pb: int) -> bool:
    """The clustering tail's packed sort key (``coarse * pb + slot``) fits
    the reference's int32 bound."""
    return nb * pb < _INT31 - 1


def packs_finest(hg: Hypergraph) -> bool:
    """Whether ``coarsen_level`` can cluster the finest level of ``hg`` at
    all: the shape ``finest_level`` pads it to, read from the net sizes
    without building the level, is inside the reference's int32 sort-key
    bound.  Past it the reference's resident descent stops before its
    first step."""
    sizes = hg.net_sizes()
    pins = int(sizes[_rd._kept_nets(sizes)].sum())
    return _packs(_bucket_fine(hg.n_vertices + 1), _bucket_fine(max(pins, 1)))


# -- clustering ---------------------------------------------------------------
def _cluster(level: DeviceLevel, cap: float, salt: int, rounds: int):
    """The reference's ``_make_clusterer`` body.  Returns (labels, rank,
    dead, sk, surv, counts) where ``counts`` holds (surviving vertices,
    surviving pins) on the device."""
    (pin_nets, net_pins, cost, w, vptr, vnets, vperm, hi, lo, lo_zero,
     vhi, vlo, vlo_zero) = level.args
    nb, pb = level.nb, level.pb
    dev = pin_nets.device
    cap32 = float(np.float32(cap))  # the reference's float32 cap, exactly
    iota = torch.arange(nb, device=dev)
    vdeg = vptr[1:] - vptr[:-1]
    net_lo = torch.where(lo_zero, 0, lo + 1)  # per-net first pin slot
    ndeg = hi + 1 - net_lo
    alive = iota < level.n_vertices
    anchor = _take(net_pins, net_lo)  # (mb,) each net's merge target vertex
    # the exact per-net term of the host similarity: c(n) / (|n| - 1)
    nscore = torch.where(ndeg >= 2, cost / (ndeg.float() - 1.0).clamp(min=1.0), -1.0)
    owner = net_pins[vperm]  # (pb,) vertex owning each vertex-CSR position
    is_lead = vperm == net_lo[vnets]  # j anchors net vnets[j]
    lo_c, vlo_c = lo.clamp(min=0), vlo.clamp(min=0)
    safe_deg = vdeg.clamp(min=1)
    vstart = vptr[:nb]

    labels, cw = iota, w.double()
    for r in range(rounds):
        root = labels == iota
        prop_role = (_hash_u32(iota, salt ^ ((r * 0x9E3779B9) & _U32)) & 1) == 1
        # a net is open iff its anchor is a live, unabsorbed acceptor —
        # only then does "grant toward the anchor" have exact weights
        can_accept = alive & root & ~prop_role
        open_net = can_accept[anchor] & (ndeg >= 2)
        # proposers: two-choice sample among incident nets by score
        h1 = _hash_u32(iota, salt ^ ((r * 0x85EBCA77) & _U32))
        h2 = _hash_u32(h1, salt ^ 0xC2B2AE35)
        i1 = vstart + h1 % safe_deg
        i2 = vstart + h2 % safe_deg
        e1, e2 = _take(vnets, i1), _take(vnets, i2)
        s1 = torch.where(open_net[e1] & (anchor[e1] != iota), nscore[e1], -1.0)
        s2 = torch.where(open_net[e2] & (anchor[e2] != iota), nscore[e2], -1.0)
        use2 = s2 > s1
        e = torch.where(use2, e2, e1)
        jslot = _take(vperm, torch.where(use2, i2, i1))  # v's own pin slot in e
        propose = alive & root & (vdeg > 0) & prop_role & (torch.maximum(s1, s2) > 0)
        # net side: each proposal rides its own pin; inclusive prefix =
        # weight committed up to and including it, in pin order
        via = propose[net_pins] & (e[net_pins] == pin_nets)
        csn = torch.cumsum(torch.where(via, cw[net_pins], 0.0), 0)
        base = torch.where(lo_zero, 0.0, csn[lo_c])
        tot = csn[hi] - base
        # anchor side: an acceptor grants its nets in CSR order; the budget
        # already committed before net vnets[j] is its own weight plus the
        # totals of its earlier nets
        led_t = torch.where(is_lead, tot[vnets], 0.0)
        csl = torch.cumsum(led_t, 0)
        base_v = torch.where(vlo_zero[owner], 0.0, csl[vlo_c[owner]])
        start_v = cw[owner] + (csl - led_t) - base_v
        start_net = _take(start_v[level.vinv], net_lo)  # to the net axis
        # the grant cutoff: one searchsorted per net over the monotone
        # prefix, against the threshold the reference forms in float32
        limit = (cap32 - start_net.float()) + base.float()
        cut = torch.minimum(torch.searchsorted(csn, limit.double(), right=True) - 1, hi)
        g_raw = torch.where(cut >= 0, csn[cut.clamp(min=0)], 0.0)
        g_net = (g_raw - base).clamp(min=0.0)
        got = propose & (start_net[e] + (csn[jslot] - base[e]) <= cap32)
        # anchors absorb the granted inflow
        csgl = torch.cumsum(torch.where(is_lead, g_net[vnets], 0.0), 0)
        inflow = csgl[vhi] - torch.where(vlo_zero, 0.0, csgl[vlo_c])
        labels = torch.where(got, anchor[e], labels)
        cw = cw + inflow

    # chains grow by at most one link per round; jump to the roots
    for _ in range(max(2, int(rounds).bit_length())):
        labels = labels[labels]
    root = (labels == iota) & alive
    rank = torch.cumsum(root.long(), 0) - 1  # root -> coarse id
    n_alive = root.sum()
    coarse_pin = rank[labels][net_pins]  # (pb,) coarse pin ids
    # dead nets: every pin in one cluster (covers singleton and phantom nets)
    diff = (coarse_pin != _take(coarse_pin, net_lo)[pin_nets]).long()
    csd = torch.cumsum(diff, 0)
    dead = (csd[hi] - torch.where(lo_zero, 0, csd[lo_c])) == 0
    keep = ~dead[pin_nets]
    # one packed sort orders surviving pins by (coarse vertex, slot): pins of
    # the same net are adjacent, so duplicates drop with an adjacent-equality
    # mask; dropped and pad entries sort to the tail as INT32_MAX
    slot = torch.arange(pb, device=dev)
    sk = torch.sort(torch.where(keep, coarse_pin * pb + slot, _KEY_PAD)).values
    valid = sk != _KEY_PAD
    scp = sk // pb
    snet = pin_nets[sk % pb]
    dup = valid & (slot > 0) & (scp == scp.roll(1)) & (snet == snet.roll(1))
    surv = valid & ~dup
    counts = torch.stack([n_alive, surv.sum()])
    return labels, rank, dead, sk, surv, counts


# -- contraction ----------------------------------------------------------------
def _contract(level: DeviceLevel, labels, rank, dead, sk, surv, n_pins2: int,
              nbb: int, pbb: int):
    """The reference's ``_make_contractor`` body: the coarse level's 13
    tensors, its ``vinv`` and the (nb,) fine -> coarse vertex map."""
    pin_nets, _, cost, w = level.args[:4]
    nb, mb, pb = level.nb, level.mb, level.pb
    dev = pin_nets.device
    dd = torch.arange(pbb, device=dev)
    # order-preserving select of the surviving sorted stream (prefix sum +
    # searchsorted): position j is already coarse-vertex order
    css = torch.cumsum(surv.long(), 0)
    srcp = torch.searchsorted(css, dd + 1)
    validj = dd < n_pins2
    skj = sk[torch.where(validj, srcp, pb - 1)]
    sortv = torch.where(validj, skj // pb, nbb - 1)
    oldslot = torch.where(validj, skj % pb, pb - 1)
    vnets2 = torch.where(validj, pin_nets[oldslot], mb - 1)
    vedges = torch.searchsorted(sortv, torch.arange(nbb + 1, device=dev))
    vl, vr = vedges[:-1], vedges[1:]
    vempty = vl == vr
    vhi2 = torch.where(vempty, pbb - 1, vr - 1)
    vlo2 = torch.where(vempty, pbb - 1, vl - 1)
    vlz2 = ~vempty & (vl == 0)
    # net view: the second pin-sized packed sort restores slot order (slots
    # unique -> nets ascend again), carrying the coarse id along
    sk3 = torch.sort(torch.where(validj, oldslot * nbb + sortv, _KEY_PAD)).values
    oslot = torch.where(validj, sk3 // nbb, pb - 1)
    np2 = torch.where(validj, sk3 % nbb, nbb - 1)
    pn2 = torch.where(validj, pin_nets[oslot], mb - 1)
    edges = torch.searchsorted(pn2, torch.arange(mb + 1, device=dev))
    left, right = edges[:-1], edges[1:]
    empty = left == right
    hi2 = torch.where(empty, pbb - 1, right - 1)
    lo2 = torch.where(empty, pbb - 1, left - 1)
    lz2 = ~empty & (left == 0)
    cost2 = torch.where(dead, 0.0, cost)
    # both permutations fall out of searchsorted into the two ascending
    # streams (slots are unique, so each query hits its own entry)
    vperm2 = torch.searchsorted(oslot, oldslot).clamp(0, pbb - 1)
    selkey = torch.where(validj, sortv * pb + oldslot, _KEY_PAD)
    vinv2 = torch.searchsorted(selkey, np2 * pb + oslot).clamp(0, pbb - 1)
    # exact coarse weights: group fine vertices by coarse id with a
    # vertex-sized packed sort
    iota = torch.arange(nb, device=dev)
    cmap = torch.where(iota < level.n_vertices, rank[labels], nbb - 1)
    skv = torch.sort(cmap * nb + iota).values
    csw = torch.cumsum(w.double()[skv % nb], 0)
    wedges = torch.searchsorted(skv // nb, torch.arange(nbb + 1, device=dev))
    wl, wr = wedges[:-1], wedges[1:]
    seg = torch.where(
        wr > wl,
        csw[(wr - 1).clamp(min=0)] - torch.where(wl > 0, csw[(wl - 1).clamp(min=0)], 0.0),
        0.0,
    )
    w2 = torch.where(torch.arange(nbb, device=dev) == nbb - 1, 0.0, seg).float()
    args2 = (pn2, np2, cost2, w2, vedges, vnets2, vperm2, hi2, lo2, lz2, vhi2, vlo2, vlz2)
    return args2, vinv2, cmap


# -- public entry point -------------------------------------------------------
def coarsen_level(
    level: DeviceLevel, cluster_cap: float, seed: int, index: int
) -> tuple[DeviceLevel, torch.Tensor, int] | None:
    """Coarsen one level on its device.  Returns ``(coarse_level, cmap,
    n_coarse)`` where ``cmap`` is a device ``(nb,)`` map from this level's
    padded vertex ids to the coarse level's (so ``batch[:, cmap]`` is the
    uncoarsening expansion), or ``None`` when clustering stalled or the
    coarse shapes would overflow the reference's int32 sort-key packing —
    the driver then stops descending."""
    nb, mb, pb = level.nb, level.mb, level.pb
    if not _packs(nb, pb):
        return None
    salt = ((seed * 0x9E3779B9) ^ ((index + 1) * 0x85EBCA77)) & _U32
    labels, rank, dead, sk, surv, counts = _cluster(level, cluster_cap, salt, CLUSTER_ROUNDS)
    n_alive, n_pins2 = counts.tolist()  # the level's one host transfer
    if n_alive >= level.n_vertices * STALL_FRACTION:
        return None
    nbb = _bucket_fine(n_alive + 1)
    pbb = _bucket_fine(max(n_pins2, 1))
    if not _packs(nbb, pb) or nbb * nb >= _INT31:
        return None
    args2, vinv2, cmap = _contract(level, labels, rank, dead, sk, surv, n_pins2, nbb, pbb)
    coarse = DeviceLevel(nb=nbb, mb=mb, pb=pbb, n_vertices=n_alive, args=args2, vinv=vinv2)
    return coarse, cmap, n_alive
