"""Layer primitives (the port of ``repro.models.layers``): norms, RoPE,
chunked causal attention (GQA and a sliding window), decode attention, the
SwiGLU/GeGLU/GeLU MLP, the capacity-dropping MoE layer and the Mamba-1
selective SSM (``mamba_block``, ``mamba_decode_step``).

Plain functions on tensors; parameters live in the dict trees that
``transformer.init_params`` makes.  Each keeps the reference's dtype flow
(which products round to the activation type, which sums run in fp32).
The MoE layer's three expert products go through K3's autograd Function
``repro_torch.kernels.moe_gemm.GroupedGemm``: its forward is one
``moe_gemm`` call (the CUDA kernel for tensors on the card, its plain
version for tensors on the CPU), under ``no_grad`` (the serve steps) too,
and its backward two more K3 products a forward one (``dx = dy @ wᵀ``,
``dw = xᵀ @ dy``), so the MoE layer trains on the card.  Attention and the
dense products are torch ops: no Pallas kernel computes them in the
reference either.  With no ``ep_group`` ``moe_layer`` takes the plain path,
every expert in this process, as the reference does with no mesh; with a
``torch.distributed`` group of tp ranks (``ep_group``, handed down by
``transformer.forward`` and ``prefill_step``) it runs the reference's
expert-parallel ``_moe_ep``: each rank holds E / tp experts
(``convert.expert_shard``) and one fp32 all-reduce combines them.  The
SSM's linear recurrence runs in fp32 as a loop over time steps with a
backward of its own (``LinearScan``); its products and the causal
convolution are torch ops, as they are jnp ops in the reference.

Under a mesh (``models.sharding``) the same functions take DTensors and
constrain the MLP's and the SSM's activations where the reference does;
the MoE dispatch and combine (``_moe_sharded``: the expert-parallel
``_moe_ep`` on the mesh's 'model' group where that axis divides the
experts), the router, the causal convolution (``_conv``) and the scan
(``_sharded_scan``) run on each rank's local shards under ``local_map``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.comm import all_reduce
from repro_torch.kernels.moe_gemm import GroupedGemm
from repro_torch.models.sharding import axis_names, axis_size, constrain, get_mesh, lies

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


def layer_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w


def apply_norm(kind: str, x, w):
    return rms_norm(x, w) if kind == "rms" else layer_norm(x, w)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float, positions: torch.Tensor) -> tuple:
    """positions: (...,) -> cos/sin of shape (..., d_head//2), fp32."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=positions.device) / d_head
    inv = 1.0 / (theta**exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); cos/sin: (B?, S, Dh//2) broadcastable."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., None, :]  # (B, S, 1, Dh//2)
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# chunked causal attention (online softmax over kv chunks)
# ---------------------------------------------------------------------------
def chunked_attention(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, S, KVH, Dh)
    v: torch.Tensor,  # (B, S, KVH, Dh)
    window: int = 0,  # 0 = full causal
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """The reference's flash-style causal attention, chunk for chunk.

    The reference scans every kv chunk for every q chunk; a chunk that lies
    wholly in a query chunk's future (or wholly past its window) adds
    exactly nothing there (its probabilities are 0 and its correction 1),
    so this loop skips it."""
    B, S, H, Dh = q.shape
    KVH = k.shape[2]
    G = H // KVH  # query groups per kv head
    scale = 1.0 / math.sqrt(Dh)
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, S)
    if S % q_chunk or S % kv_chunk:
        raise ValueError(f"S={S} not divisible by chunks {q_chunk}/{kv_chunk}")
    nq, nk = S // q_chunk, S // kv_chunk
    dev = q.device

    qr = q.reshape(B, nq, q_chunk, KVH, G, Dh)
    kr = k.reshape(B, nk, kv_chunk, KVH, Dh)
    vr = v.reshape(B, nk, kv_chunk, KVH, Dh)
    outs = []
    for qi in range(nq):
        q_blk = qr[:, qi]
        q_lo, q_hi = qi * q_chunk, (qi + 1) * q_chunk - 1
        m = torch.full((B, KVH, G, q_chunk), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KVH, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KVH, G, q_chunk, Dh), dtype=torch.float32, device=dev)
        q_pos = q_lo + torch.arange(q_chunk, device=dev)
        for ki in range(nk):
            k_lo, k_hi = ki * kv_chunk, (ki + 1) * kv_chunk - 1
            if k_lo > q_hi or (window and q_lo - k_hi >= window):
                continue  # wholly masked for every query of the chunk
            k_blk, v_blk = kr[:, ki], vr[:, ki]
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk) * scale
            k_pos = k_lo + torch.arange(kv_chunk, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]
            if window:
                mask &= q_pos[:, None] - k_pos[None, :] < window
            s = s.masked_fill(~mask, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows
            m_inf = torch.isinf(m_new)
            m_safe = m_new.masked_fill(m_inf, 0.0)
            p = torch.exp(s - m_safe[..., None]).masked_fill(m_inf[..., None], 0.0)
            corr = torch.exp(m.masked_fill(torch.isinf(m), 0.0) - m_safe)
            corr = corr.masked_fill(torch.isinf(m), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v_blk.dtype), v_blk
            )
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-20)[..., None])  # (B, KVH, G, qc, Dh)
    out = torch.stack(outs, dim=1)  # (B, nq, KVH, G, qc, Dh)
    out = out.permute(0, 2, 3, 1, 4, 5)  # (B, KVH, G, nq, qc, Dh)
    return out.reshape(B, KVH * G, S, Dh).transpose(1, 2).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, Dh)
    k_cache: torch.Tensor,  # (B, C, KVH, Dh)
    v_cache: torch.Tensor,  # (B, C, KVH, Dh)
    cache_pos: torch.Tensor,  # (C,) absolute positions, -1 = empty slot
    cur_pos: torch.Tensor,  # () current absolute position
    window: int = 0,
) -> torch.Tensor:
    B, _, H, Dh = q.shape
    p = torch.softmax(decode_scores(q, k_cache, cache_pos, cur_pos, window), dim=-1)
    out = torch.einsum("bhgc,bchd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, Dh)


def decode_scores(q, k_cache, cache_pos, cur_pos, window: int = 0) -> torch.Tensor:
    """One token's attention scores over the cache's slots, (B, KVH, G, C)
    in fp32: scaled, and -inf where a slot is empty, ahead of ``cur_pos``
    or out of the window (``decode_attention``'s, and each slot shard's
    under a mesh)."""
    B, _, H, Dh = q.shape
    KVH = k_cache.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(Dh)
    qr = q.reshape(B, KVH, G, Dh)
    s = torch.einsum("bhgd,bchd->bhgc", qr, k_cache).float() * scale
    valid = (cache_pos >= 0) & (cache_pos <= cur_pos)
    if window:
        valid &= cur_pos - cache_pos < window
    return s.masked_fill(~valid, -math.inf)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ params["wi"]
    if act in ("swiglu", "geglu"):
        g = x @ params["wg"]
        gate = F.silu(g) if act == "swiglu" else gelu(g)
        h = h * gate
    else:
        h = gelu(h)
    h = constrain(h, "batch", "seq", "ff")
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# MoE: top-k routing with capacity, experts on the grouped GEMM (K3)
# ---------------------------------------------------------------------------
def expert_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[e] = x[e] @ w[e]`` on K3, with tiles the whole of each dim (the
    TPU tiles' contract would refuse C = 160 or 1; these always divide),
    through ``GroupedGemm``: one ``moe_gemm`` call, and K3's backward where
    autograd records."""
    E, C, d = x.shape
    return GroupedGemm.apply(x, w, C, w.shape[2], d)


def _moe_dispatch_combine(xt, fe, ft, fg, wi, wg, wo, n_experts, cap, act_dtype, ahead=None):
    """Dispatch -> grouped GEMM (three K3 calls) -> combine on sorted
    (expert, token, gate) pair lists.  fe must be sorted ascending; fe ==
    n_experts marks dropped/foreign pairs.  Each slot below the sink row
    takes at most one pair.  A pair is kept while its place in its
    expert's queue is below ``cap``; ``ahead`` (n_experts,), where given,
    counts the pairs queued before these in each expert's (an earlier
    batch shard's, under a mesh).  The buffer holds min(cap, T) slots an
    expert: a token routes to an expert once.  Returns the combine's (T, d) sums in fp32:
    each gated contribution rounded to the activation dtype, as the
    reference rounds it, and a token's K of them summed in fp32, so the
    caller rounds once (the reference sums them in the activation dtype).
    In 16-bit types the sums are then exact whatever their order (the
    card's atomics, or the expert-parallel ranks' partials), where bf16
    sums taken in another order differ by bf16 ulps."""
    T, d = xt.shape
    n = fe.numel()
    pos_in_e = torch.arange(n, device=fe.device) - torch.searchsorted(fe, fe, side="left")
    place = pos_in_e if ahead is None else pos_in_e + ahead[torch.clamp(fe, max=n_experts - 1)]
    keep = (place < cap) & (fe < n_experts)
    rows = min(cap, T)
    slot = torch.where(keep, fe * rows + pos_in_e, n_experts * rows)
    buf = torch.zeros((n_experts * rows + 1, d), dtype=act_dtype, device=xt.device)
    # where autograd records, gathered from an fp32 copy of xt: the same
    # values, but the gather's backward, a scatter-add of a token's K
    # gradients, then sums them in fp32 and rounds once to xt's type.  K = 8
    # bf16 values (8 significant bits) whose magnitudes span less than 2^13
    # sum exactly in the 24 bits of fp32 (3 bits of carry), so the card's
    # atomics then give the same bf16 gradient in any order; beyond that
    # span two orders may differ by fp32 ulps, and round to bf16 values an
    # ulp apart where the sum lies that near halfway between two.  Summed in
    # bf16 they would differ by bf16 ulps.  Serving gathers xt as it is.
    src = xt.float() if torch.is_grad_enabled() and xt.requires_grad else xt
    buf.index_add_(0, slot, (src[ft] * keep[:, None]).to(act_dtype))
    expert_in = buf[:-1].reshape(n_experts, rows, d)

    h = expert_gemm(expert_in, wi)
    g = expert_gemm(expert_in, wg)
    h = h * F.silu(g)
    expert_out = expert_gemm(h, wo)  # (E, rows, d)

    flat_out = expert_out.reshape(n_experts * rows, d)
    contrib = flat_out[torch.clamp(slot, max=n_experts * rows - 1)] * (fg * keep)[:, None]
    out = torch.zeros((T, d), dtype=torch.float32, device=xt.device)
    return out.index_add_(0, ft, contrib.to(act_dtype).float())


def _sorted_pairs(gate_idx, gate_vals, T, K):
    """Pairs sorted by expert, stably: which pairs a full expert drops
    depends on this order, as in the reference's stable ``argsort``."""
    flat_expert = gate_idx.reshape(-1)
    flat_token = torch.arange(T, device=gate_idx.device).repeat_interleave(K)
    flat_gate = gate_vals.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    return flat_expert[order], flat_token[order], flat_gate[order]


@functools.lru_cache(maxsize=16)
def _placement_perm(placement: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The expert placement as an index tensor on ``device``, built once:
    a copy from the host waits for the card, so no step may make one."""
    return torch.tensor(placement, dtype=torch.int64, device=device)


def _moe_ep(xt, gate_idx, gate_vals, params, cfg, group):
    """Expert-parallel dispatch over ``group`` (the reference's ``_moe_ep``
    body on one column of its ``model`` axis): this rank holds experts
    ``[rank E_loc, (rank + 1) E_loc)`` of ``E = E_loc tp`` and every token.
    Its pairs are the ones routed to those experts, sorted stably by local
    expert (the others sink past ``E_loc``), dispatched at the global
    ``cap = ceil(T K / E * capacity_factor)`` through K3, and the ranks'
    fp32 partial sums are summed by one all-reduce before the one cast."""
    moe = cfg.moe
    T, _ = xt.shape
    E, K = moe.n_experts, moe.top_k
    tp, col = dist.get_world_size(group), dist.get_rank(group)
    if E % tp:
        raise ValueError(f"{E} experts do not split over {tp} expert-parallel ranks")
    E_loc = E // tp
    cap = int(math.ceil(max(T, 1) * K / E * moe.capacity_factor))
    local_e = gate_idx - col * E_loc
    mine = (local_e >= 0) & (local_e < E_loc)
    fe_all = torch.where(mine, local_e, E_loc).reshape(-1)
    order = torch.argsort(fe_all, stable=True)
    fe = fe_all[order]
    ft = torch.arange(T, device=xt.device).repeat_interleave(K)[order]
    fg = gate_vals.reshape(-1)[order]
    out = _moe_dispatch_combine(
        xt, fe, ft, fg, params["wi"], params["wg"], params["wo"], E_loc, cap, xt.dtype
    )
    # combine across expert columns: one all-reduce over the group
    return all_reduce(out, group).to(xt.dtype)


def _route(logits: torch.Tensor, K: int):
    """(probs, gate values, gate ids) of the router's fp32 logits (T, E):
    softmax over the experts, the top K, their values renormalised."""
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)  # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def _token_placements(mesh, T: int) -> tuple:
    """Where the MoE's tokens lie in the reference's ``_moe_ep``: split
    over the batch axes ('pod', 'data') where they divide T, replicated
    over the rest."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    batch = [a for a in ("pod", "data") if a in names]
    split = T % math.prod(axis_size(mesh, a) for a in batch) == 0
    return tuple(Shard(0) if split and n in batch else Replicate() for n in names)


def _counts(gate_idx: torch.Tensor, E: int, dtype=torch.float32) -> torch.Tensor:
    """Pairs routed to each expert (fp32 by default: exact below 2^24)."""
    flat = gate_idx.reshape(-1)
    ones = torch.ones(flat.shape, dtype=dtype, device=flat.device)
    return torch.zeros(E, dtype=dtype, device=flat.device).index_add_(0, flat, ones)


def _expert_counts(gate_idx, E: int, mesh):
    """``_counts`` of ``gate_idx``; under ``mesh``, each rank counts its own
    tokens (``local_map``) into a partial sum over the axes that split them."""
    if mesh is None:
        return _counts(gate_idx, E)
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    tok = _token_placements(mesh, gate_idx.shape[0])
    out = tuple(Partial() if isinstance(p, Shard) else p for p in tok)
    # (one output: its placements a list, where a tuple would list outputs)
    return local_map(functools.partial(_counts, E=E), out_placements=list(out), in_placements=(tok,),
                     device_mesh=mesh, redistribute_inputs=True)(gate_idx)


def _queued_ahead(counts: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Inside a ``local_map`` region: of this batch shard's per-expert pair
    ``counts``, the pairs of each expert that earlier shards' tokens route
    (the shards in mesh order over ``axes``, the major first), so the
    shard keeps the pairs the whole batch's queue keeps.  One all-gather
    of the (E,) counts over each axis, the minor first."""
    ahead = torch.zeros_like(counts)
    total = counts
    for a in reversed(axes):
        every = counts.new_empty(axis_size(mesh, a) * counts.numel())
        dist.all_gather_into_tensor(every, total, group=mesh.get_group(a))
        every = every.view(-1, counts.numel())
        ahead += every[:mesh.get_local_rank(a)].sum(0)
        total = every.sum(0)  # this axis's shards together, for the next
    return ahead


def _moe_sharded(xt, gate_idx, gate_vals, params, cfg, mesh):
    """The MoE dispatch and combine on DTensors under ``mesh``, each rank on
    its local shards (``local_map``), with K3 on plain local tensors, as the
    reference's ``moe_layer`` under a mesh.  The tokens stay split over the
    batch axes where those divide T, and the expert weights are gathered
    over the FSDP 'data' axis only.  Where the 'model' axis is > 1 and
    divides the experts, the reference's expert-parallel ``_moe_ep``
    (experts split over 'model', ``cap`` from this rank's T, one fp32
    all-reduce over the 'model' group).  Elsewhere the reference's plain
    path: every expert on every rank, and a shard keeps the pairs the whole
    batch's queue keeps at the global ``cap`` (``_queued_ahead``, where
    more than one rank splits the tokens)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    moe = cfg.moe
    names = axis_names(mesh)
    tp = axis_size(mesh, "model") if "model" in names else 1
    perm = None if moe.expert_placement is None else tuple(moe.expert_placement)
    ids = lambda gi: gi if perm is None else _placement_perm(perm, gi.device)[gi]
    tok = _token_placements(mesh, xt.shape[0])
    # gradients: a token shard's of the experts are partial sums
    exp_grad = lambda e: tuple(e[i] if n == "model" else (Partial() if isinstance(p, Shard) else p)
                               for i, (n, p) in enumerate(zip(names, tok)))
    if tp > 1 and moe.n_experts % tp == 0:
        experts = tuple(Shard(0) if n == "model" else Replicate() for n in names)
        # a model column's gradients of the tokens are partial sums too
        tok_grad = tuple(Partial() if n == "model" else p for n, p in zip(names, tok))
        grads = (tok_grad, tok, tok_grad) + (exp_grad(experts),) * 3
        group = mesh.get_group("model")

        def body(xt, gi, gv, wi, wg, wo):
            return _moe_ep(xt, ids(gi), gv, {"wi": wi, "wg": wg, "wo": wo}, cfg, group)
    else:
        experts = (Replicate(),) * len(names)
        grads = (tok,) * 3 + (exp_grad(experts),) * 3
        E, K = moe.n_experts, moe.top_k
        cap = int(math.ceil(xt.shape[0] * K / E * moe.capacity_factor))
        split = [n for n, p in zip(names, tok) if isinstance(p, Shard) and axis_size(mesh, n) > 1]

        def body(xt, gi, gv, wi, wg, wo):
            T, gi = xt.shape[0], ids(gi)
            ahead = _queued_ahead(_counts(gi, E, torch.int64), mesh, split) if split else None
            fe, ft, fg = _sorted_pairs(gi, gv, T, K)
            out = _moe_dispatch_combine(xt, fe, ft, fg, wi, wg, wo, E, cap, xt.dtype, ahead)
            return out.to(xt.dtype)

    return local_map(
        body, out_placements=list(tok), in_placements=(tok,) * 3 + (experts,) * 3,
        in_grad_placements=grads, device_mesh=mesh, redistribute_inputs=True,
    )(xt, gate_idx, gate_vals, params["wi"], params["wg"], params["wo"])


def moe_layer(params: dict, x: torch.Tensor, cfg, ep_group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss).

    Token-dropping capacity MoE with sort-based dispatch (no (T, E, C)
    one-hot tensor).  With no ``ep_group``, the reference's plain path:
    every expert on this device, ``cap = ceil(T K / E * capacity_factor)``
    rows each.  With a group of tp ranks, its expert-parallel path
    (``_moe_ep``): ``params`` hold this rank's E / tp experts
    (``convert.expert_shard``).  With ``cfg.moe.expert_placement`` (from
    ``core.moe_planner``) the routed expert ids are permuted first, as in
    the reference."""
    moe = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = moe.n_experts, moe.top_k
    xt = x.reshape(T, d)

    mesh = get_mesh() if isinstance(x, DTensor) else None
    if isinstance(x, DTensor) and mesh is None:
        raise ValueError("DTensor activations need an ambient mesh (sharding.set_mesh; the "
                         "step builders set their parameters' mesh)")
    # the router is fp32: the reference promotes xt @ router to fp32
    logits = xt.float() @ params["router"]  # (T, E)
    if mesh is None:
        probs, gate_vals, gate_idx = _route(logits, K)
    else:  # each rank routes its own tokens over every expert
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.experimental import local_map

        tok = _token_placements(mesh, T)
        probs, gate_vals, gate_idx = local_map(
            functools.partial(_route, K=K), out_placements=(tok, tok, tok), in_placements=(tok,),
            device_mesh=mesh, redistribute_inputs=True)(logits)
    if mesh is not None and ep_group is not None:
        raise ValueError("moe_layer under a mesh takes its expert-parallel group from the mesh")
    # aux load-balancing loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = _expert_counts(gate_idx, E, mesh) / (T * K)
    aux = E * torch.sum(me * ce) * moe.router_aux_coef
    if mesh is not None:
        return _moe_sharded(xt, gate_idx, gate_vals, params, cfg, mesh).reshape(B, S, d), aux

    if moe.expert_placement is not None:
        gate_idx = _placement_perm(tuple(moe.expert_placement), x.device)[gate_idx]

    held = params["wi"].shape[0]
    tp = 1 if ep_group is None else dist.get_world_size(ep_group)
    if held * tp != E:
        raise ValueError(
            f"the MoE layer holds {held} experts a rank over {tp} rank(s), not "
            f"{E}: expert-sharded parameters need their ep_group"
        )
    if ep_group is not None:
        out = _moe_ep(xt, gate_idx, gate_vals, params, cfg, ep_group)
        return out.reshape(B, S, d), aux

    cap = int(math.ceil(T * K / E * moe.capacity_factor))
    fe, ft, fg = _sorted_pairs(gate_idx, gate_vals, T, K)
    out = _moe_dispatch_combine(
        xt, fe, ft, fg, params["wi"], params["wg"], params["wo"], E, cap, xt.dtype
    )
    return out.to(xt.dtype).reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Mamba-1 selective SSM
# ---------------------------------------------------------------------------
def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, Di); w: (Kc, Di) depthwise causal conv, as a sum of shifted
    copies (Kc is tiny — 4), added in x's type in the order i = 0..Kc-1 as
    the reference adds them (``F.conv1d`` would sum in another precision
    and order, and round 16-bit results away from the reference's)."""
    Kc, S = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(Kc):
        shift = Kc - 1 - i
        xs = F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xs * w[i]
    return out


def _conv(x, w):
    """``_causal_conv``; on DTensors, each rank convolves its own rows and
    channels (``local_map``: the convolution runs along the sequence, which
    no rule splits, and is depthwise), the kernel's channels split as x's
    and its gradient a partial sum over the dims that split the rows."""
    if not isinstance(x, DTensor):
        return _causal_conv(x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    xp = tuple(Replicate() if isinstance(p, Partial) else p for p in lies(x))
    if Shard(1) in xp:
        raise ValueError(f"the causal convolution's sequence is split ({x.placements})")
    wp = tuple(Shard(1) if p == Shard(2) else Replicate() for p in xp)
    wg = tuple(Partial() if p == Shard(0) else q for p, q in zip(xp, wp))
    return local_map(_causal_conv, out_placements=list(xp), in_placements=(xp, wp),
                     in_grad_placements=(xp, wg), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, w)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it, x * (1 / (1 + e^-x)),
    each op rounded to x's type (``F.silu`` rounds once, and differs from
    the reference by an ulp on about a third of bf16 inputs)."""
    return x * torch.reciprocal(torch.exp(-x) + 1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) as the reference computes
    it, max(x, 0) + log1p(e^-|x|), each op rounded to x's type."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp(min=0)


class LinearScan(torch.autograd.Function):
    """h_t = a_t h_{t-1} + bx_t over axis 0 of time-major (S, ...) tensors
    from h_{-1} = h0 (...); returns every h_t, time-major and contiguous.

    The forward is one ``addcmul`` a time step, each writing its slice of
    the output: every step reads a_t, bx_t and h_{t-1} once and writes h_t
    once, the least traffic a scan over HBM can make (a log-depth doubling
    scan moves its tensors once a level).  Time-major, a step's operands
    are contiguous slices; batch-major ones would lie a whole sequence
    apart, and past 2^31 bytes that splits every step's kernel in two.  No
    closed form is used: with ``L = cumsum(log a)``, ``exp(-L)`` overflows
    fp32 within a few hundred steps at the decays falcon-mamba's widths
    give (log a down to -16).  The backward is the reverse recurrence
    g_t = dh_t + a_{t+1} g_{t+1} (g_{S-1} = dh_{S-1}): ``bx``'s gradient is
    g, ``a``'s is g_t h_{t-1} and ``h0``'s is a_0 g_0.  It saves ``a`` and
    the states (and ``h0``), where autograd through the steps would keep
    each step's graph."""

    @staticmethod
    def forward(ctx, a, bx, h0):
        h = torch.empty(bx.shape, dtype=torch.promote_types(a.dtype, bx.dtype),
                        device=bx.device)
        prev = h0
        for a_t, bx_t, out in zip(a.unbind(0), bx.unbind(0), h.unbind(0)):
            prev = torch.addcmul(bx_t, a_t, prev, out=out)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        g = torch.empty(h.shape, dtype=h.dtype, device=h.device)
        g_steps, a_steps, dh_steps = g.unbind(0), a.unbind(0), dh.unbind(0)
        nxt = g_steps[-1].copy_(dh_steps[-1])
        for t in range(len(g_steps) - 2, -1, -1):
            nxt = torch.addcmul(dh_steps[t], a_steps[t + 1], nxt, out=g_steps[t])
        da = dh0 = None
        if ctx.needs_input_grad[0]:
            da = torch.empty_like(g)
            torch.mul(g[1:], h[:-1], out=da[1:])
            torch.mul(g[0], h0, out=da[0])
        if ctx.needs_input_grad[2]:
            dh0 = a[0] * g[0]
        return da, g, dh0


def mamba_scan(
    a: torch.Tensor,  # (B, S, Di, N) decay = exp(dt * A)
    bx: torch.Tensor,  # (B, S, Di, N) input contribution dt * B_t * x_t
    h0: torch.Tensor,  # (B, Di, N)
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The linear recurrence h_t = a_t * h_{t-1} + bx_t; returns (h_all,
    h_last).  S must be a multiple of ``min(chunk, S)``, as in the
    reference, whose chunks scan one after another carrying h; the port's
    steps run one after another in any case (``LinearScan``), so the chunk
    changes no value.  ``h_all`` is a (B, S, ...) view of the time-major
    states (``LinearScan``): its steps are contiguous where ``a`` and
    ``bx`` are such views too.  ``h_last`` is a copy: a view would keep the
    whole of ``h_all`` alive as long as a cache holds it."""
    S = a.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} not divisible by chunk={chunk}")
    if isinstance(a, DTensor):
        h = _sharded_scan(a, bx, h0)
        return h, h[:, -1].clone()
    h = LinearScan.apply(a.transpose(0, 1), bx.transpose(0, 1), h0)
    return h.transpose(0, 1), h[-1].clone()


def _scan_batch_major(a, bx, h0):
    """``LinearScan`` of batch-major (B, S, ...) operands, time-major
    copies in and a batch-major view of the states out."""
    return LinearScan.apply(a.transpose(0, 1).contiguous(), bx.transpose(0, 1).contiguous(),
                            h0).transpose(0, 1)


def _sharded_scan(a, bx, h0):
    """The scan of batch-major DTensors, each rank scanning its own shards
    (``local_map``): the recurrence runs along time (dim 1), which no rule
    splits, and is elementwise in every other dim, so a rank's states need
    nothing of another's.  One op a time step on local tensors, where
    DTensor would dispatch each of them."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(Replicate() if isinstance(p, Partial) else p for p in lies(a))
    if any(isinstance(p, Shard) and p.dim == 1 for p in pl):
        raise ValueError(f"the SSM scan's time axis is sharded ({a.placements})")
    h0_pl = tuple(Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard) else p for p in pl)
    return local_map(_scan_batch_major, out_placements=list(pl), in_placements=(pl, pl, h0_pl),
                     device_mesh=a.device_mesh, redistribute_inputs=True)(a, bx, h0)


def _ssm_inputs(params: dict, xc: torch.Tensor):
    """The data-dependent SSM parameters of the convolved activations xc:
    (decay (..., Di, N) fp32, bx (..., Di, N) fp32, ct (..., N))."""
    bt = xc @ params["x_proj_b"]  # (..., N)
    ct = xc @ params["x_proj_c"]  # (..., N)
    dt = _softplus(xc * params["dt_proj"]).float()
    a = -torch.exp(params["a_log"].float())  # (Di, N)
    # the linear recurrence runs in fp32 (SSM stability + uniform scan dtypes)
    decay = torch.exp(dt[..., None] * a)
    bx = (dt * xc.float())[..., None] * bt.float()[..., None, :]
    return decay, bx, ct


def mamba_block_with_state(
    params: dict,
    x: torch.Tensor,  # (B, S, d)
    cfg,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mamba-1 block.  Returns (y, conv_tail (B, Kc-1, Di), h_last).

    ``dt`` is elementwise (``softplus(xc * dt_proj)``), as in the
    reference; the scan's read-out is rounded to x's type before the skip
    term is added."""
    xz = constrain(x @ params["in_proj"], "batch", "seq", "ssm_inner")
    z = x @ params["gate_proj"]  # (B, S, Di)
    xc = constrain(_silu(_conv(xz, params["conv_w"])), "batch", "seq", "ssm_inner")
    if isinstance(xc, DTensor):  # batch-major: each rank scans its shards (``_sharded_scan``)
        decay, bx, ct = _ssm_inputs(params, xc)
        h_all, h_last = mamba_scan(decay, bx, torch.zeros_like(decay[:, 0]), chunk=chunk)
        read = torch.einsum("bsdn,bsn->bsd", h_all, ct.float())
    else:
        # the SSM's (S, B, ...) operands time-major, each step's slice contiguous
        decay, bx, ct = _ssm_inputs(params, xc.transpose(0, 1).contiguous())
        h0 = torch.zeros(decay.shape[1:], dtype=torch.float32, device=x.device)
        h_all, h_last = mamba_scan(decay.transpose(0, 1), bx.transpose(0, 1), h0, chunk=chunk)
        read = torch.einsum("sbdn,sbn->sbd", h_all.transpose(0, 1), ct.float()).transpose(0, 1)
    y = read.to(x.dtype) + xc * params["d_skip"]
    y = y * _silu(z)
    Kc = params["conv_w"].shape[0]
    conv_tail = xz[:, -(Kc - 1):, :].clone()  # a copy, as h_last
    return (y @ params["out_proj"]).to(x.dtype), conv_tail, h_last


def mamba_block(params: dict, x: torch.Tensor, cfg, chunk: int = 256) -> torch.Tensor:
    y, _, _ = mamba_block_with_state(params, x, cfg, chunk=chunk)
    return y


def mamba_decode_step(
    params: dict,
    x: torch.Tensor,  # (B, 1, d)
    conv_state: torch.Tensor,  # (B, Kc-1, Di)
    h: torch.Tensor,  # (B, Di, N)
    cfg,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token Mamba step with carried (conv_state, h); returns (y,
    the new conv_state, the new h), h in fp32."""
    xz = x @ params["in_proj"]  # (B, 1, Di)
    z = x @ params["gate_proj"]
    w = params["conv_w"]  # (Kc, Di)
    full = torch.cat([conv_state, xz], dim=1)  # (B, Kc, Di)
    xc = _silu((full * w[None]).sum(dim=1, keepdim=True))  # (B, 1, Di)
    decay, bx, ct = _ssm_inputs(params, xc[:, 0])  # (B, Di, N), (B, Di, N), (B, N)
    h_new = decay * h + bx  # h carried in fp32
    y = torch.einsum("bdn,bn->bd", h_new, ct.float()).to(x.dtype)[:, None] + xc * params["d_skip"]
    y = y * _silu(z)
    return (y @ params["out_proj"]).to(x.dtype), full[:, 1:], h_new
