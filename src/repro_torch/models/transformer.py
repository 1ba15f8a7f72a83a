"""Full decoder model (the port of ``repro.models.transformer``): init,
forward (train/prefill), ``train_loss``, decode step, KV cache.

Parameters are the reference's tree (nested dicts of tensors), layers
stacked on a leading ``n_layers`` axis.  Where the reference scans that
axis with ``lax.scan``, the port runs a Python loop over it, over slices
taken once a call (``layer_slices``).  ``forward(remat=True)`` checkpoints
each layer's activations by ``cfg.remat_policy`` where autograd records,
as the reference's ``jax.checkpoint`` does.  Every entry point takes its
device explicitly and runs on the card unless told otherwise
(``device="cpu"``); a step runs where its parameters lie.

Under an ambient mesh (``models.sharding.set_mesh``; the step builders
set their DTensor parameters' mesh) the parameters, batch and cache are
DTensors: the
activations are constrained where the reference constrains them
(``sharding.constrain``), attention runs on each rank's batch rows and
heads (``_by_heads``, ``local_map``), a decode step writes its slot on the
cache's local shards (``_write_slot``), and the loss picks each label
from the vocab shard that holds it (``_sharded_label_logp``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch._device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (
    cache_logical_axes,
    constrain,
    lies,
    map_axes,
    mesh_ops,
    param_logical_axes,
    serve_overlay,
)


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(
    cfg: ModelConfig,
    generator: torch.Generator | int = 0,
    device=None,
) -> dict:
    """Materialize parameters: the reference's tree, shapes, dtypes and
    scales (normal draws times the reference's scale, cast to ``cfg.dtype``;
    the router in fp32), drawn from ``generator`` (or a generator on
    ``device`` seeded with it) on ``device`` (the card unless named).  On
    the ``meta`` device only shapes and dtypes are made (``param_count``).
    Stacked weights are drawn one layer at a time, so no fp32 copy of a
    whole stack is ever held."""
    device = torch.device("meta") if device == "meta" else resolve_device(device)
    meta = device.type == "meta"
    if not meta and not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=device).manual_seed(int(generator))
    dt = _dtype(cfg.dtype)
    d, H, KVH, Dh, F, V, Ln = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab,
        cfg.n_layers,
    )

    def draw(shape, scale, dtype=dt, stacked=False):
        out = torch.empty(shape, dtype=dtype, device=device)
        if meta:
            return out
        for piece in (out if stacked else (out,)):
            piece.copy_(torch.randn(piece.shape, generator=generator, device=device) * scale)
        return out

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=device)

    s_embed = 1.0 / np.sqrt(d)
    params: dict = {
        "embed": {"tokens": draw((V, d), s_embed)},
        "final_norm": full((d,), 1.0),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = draw((d, V), s_embed)
    layer: dict = {"ln1": full((Ln, d), 1.0), "ln2": full((Ln, d), 1.0)}
    if cfg.layer_kind in ("attn", "hybrid"):
        attn = {
            "wq": draw((Ln, d, H, Dh), s_embed, stacked=True),
            "wk": draw((Ln, d, KVH, Dh), s_embed, stacked=True),
            "wv": draw((Ln, d, KVH, Dh), s_embed, stacked=True),
            "wo": draw((Ln, H, Dh, d), 1.0 / np.sqrt(H * Dh), stacked=True),
        }
        if cfg.qkv_bias:
            attn["bq"] = full((Ln, H, Dh), 0.0)
            attn["bk"] = full((Ln, KVH, Dh), 0.0)
            attn["bv"] = full((Ln, KVH, Dh), 0.0)
        layer["attn"] = attn
    if cfg.layer_kind in ("mamba", "hybrid"):
        Di = cfg.d_inner
        N = cfg.ssm.d_state if cfg.ssm else 16
        Kc = cfg.ssm.d_conv if cfg.ssm else 4
        a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=device))
        layer["ssm"] = {
            "in_proj": draw((Ln, d, Di), s_embed, stacked=True),
            "gate_proj": draw((Ln, d, Di), s_embed, stacked=True),
            "conv_w": draw((Ln, Kc, Di), 0.5, stacked=True),
            "x_proj_b": draw((Ln, Di, N), s_embed, stacked=True),
            "x_proj_c": draw((Ln, Di, N), s_embed, stacked=True),
            "dt_proj": full((Ln, Di), 1.0) * 0.1,
            "a_log": a_log[None, None].repeat(Ln, Di, 1).to(dt),
            "d_skip": full((Ln, Di), 1.0),
            "out_proj": draw((Ln, Di, d), 1.0 / np.sqrt(Di), stacked=True),
        }
    if cfg.moe is not None:
        E, Fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        layer["moe"] = {
            "router": draw((Ln, d, E), s_embed, torch.float32, stacked=True),
            "wi": draw((Ln, E, d, Fe), s_embed, stacked=True),
            "wg": draw((Ln, E, d, Fe), s_embed, stacked=True),
            "wo": draw((Ln, E, Fe, d), 1.0 / np.sqrt(Fe), stacked=True),
        }
        if cfg.moe.n_shared_experts:
            layer["shared_mlp"] = {
                "wi": draw((Ln, d, F), s_embed, stacked=True),
                "wg": draw((Ln, d, F), s_embed, stacked=True),
                "wo": draw((Ln, F, d), 1.0 / np.sqrt(F), stacked=True),
            }
    elif F > 0:  # F == 0: no FFN sub-block (pure-Mamba archs)
        mlp = {
            "wi": draw((Ln, d, F), s_embed, stacked=True),
            "wo": draw((Ln, F, d), 1.0 / np.sqrt(F), stacked=True),
        }
        if cfg.act in ("swiglu", "geglu"):
            mlp["wg"] = draw((Ln, d, F), s_embed, stacked=True)
        layer["mlp"] = mlp
    params["layers"] = layer
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(cfg: ModelConfig) -> int:
    return sum(t.numel() for t in _leaves(init_params(cfg, device="meta")))


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top_k of n_experts)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    moe = init_params(cfg, device="meta")["layers"]["moe"]
    expert = sum(moe[k].numel() for k in ("wi", "wg", "wo"))
    active_frac = cfg.moe.top_k / cfg.moe.n_experts
    return total - expert + int(expert * active_frac)


def _unbind(tree: dict) -> list[dict]:
    per = None
    for k, v in tree.items():
        parts = _unbind(v) if isinstance(v, dict) else v.unbind(0)
        per = per or [{} for _ in parts]
        for layer, part in zip(per, parts):
            layer[k] = part
    return per


def layer_slices(params: dict) -> list[dict]:
    """Every layer's slice of the stacked layer tree, taken once (views, no
    copy).  ``unbind`` and not ``t[i]``: the backward of n ``select``s
    makes a zero gradient of the whole stack for each layer and sums them,
    where ``unbind``'s stacks the layers' gradients once."""
    return _unbind(params["layers"])


# ---------------------------------------------------------------------------
# layer body (shared by prefill and decode)
# ---------------------------------------------------------------------------
def _whole_heads(t, h: int):
    """A DTensor whose last dim is (h k) flattened, with that dim's split
    over any mesh dim whose size does not divide h gathered: DTensor views
    (h k) as (h, k) only where each shard holds whole heads."""
    if not isinstance(t, DTensor):
        return t
    mesh, keep = t.device_mesh, []
    for i, p in enumerate(lies(t)):
        split = p == Shard(t.ndim - 1) and h % mesh.size(i)
        keep.append(Replicate() if split else p)
    return t if tuple(keep) == lies(t) else t.redistribute(mesh, keep)


class _FlatHeads(torch.autograd.Function):
    """A DTensor weight (d, h, k) viewed (d, h k); its gradient, which DTensor
    may split over (h k) as it likes, is given whole heads
    (``_whole_heads``) before the view back."""

    @staticmethod
    def forward(ctx, w):
        ctx.shape = w.shape
        return w.reshape(w.shape[0], -1)

    @staticmethod
    def backward(ctx, g):
        return _whole_heads(g, ctx.shape[1]).reshape(ctx.shape)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    if isinstance(w, DTensor):
        return _whole_heads(x @ _FlatHeads.apply(w), h).unflatten(-1, (h, k))
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _out_project(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = w.shape
    return o.flatten(-2) @ w.reshape(h * k, d)


def _qkv(lp, x, cfg: ModelConfig, positions):
    a = lp["attn"]
    q, k, v = _project(x, a["wq"]), _project(x, a["wk"]), _project(x, a["wv"])
    if cfg.qkv_bias:
        q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
    if cfg.use_rope:
        cos, sin = L.rope_freqs(cfg.head_dim, cfg.rope_theta, positions)
        q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    return q, k, v


def _attn_branch(lp, x, cfg: ModelConfig, positions, window):
    q, k, v = _qkv(lp, x, cfg, positions)
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
    v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
    if isinstance(q, DTensor):
        o = _by_heads(q, k, v, cfg, functools.partial(L.chunked_attention, window=window))
    else:
        o = L.chunked_attention(q, k, v, window=window)
    o = constrain(o, "batch", "seq", "heads", "head_dim")
    return _out_project(o, lp["attn"]["wo"]), (k, v)


def _by_heads(q, k, v, cfg: ModelConfig, attend, *extra):
    """``attend(q, k, v, *extra)`` on each rank's shards of DTensors
    (``local_map``): attention is independent across the batch and the
    heads, so a rank attends its own rows and query heads.  Where the
    query heads are split over a mesh dim that the kv heads are not (fewer
    kv heads than its size), each rank takes from its whole kv heads the
    ones its query heads read, and gets only its share of their gradient,
    a partial sum.  ``extra`` (replicated) goes in as it lies."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    # each mesh dim splits the batch (dim 0) of all three, or the heads (dim
    # 2) of q and of k and v where they have enough, or nothing
    qp, kp = [], []
    for a, b in zip(lies(q), lies(k)):
        if Shard(0) in (a, b):
            qp.append(Shard(0)), kp.append(Shard(0))
        elif Shard(2) in (a, b):
            qp.append(Shard(2)), kp.append(b if b == Shard(2) else Replicate())
        else:
            qp.append(Replicate()), kp.append(Replicate())
    qp, kp = tuple(qp), tuple(kp)
    split = [i for i, p in enumerate(qp) if p == Shard(2)]
    apart = [i for i in split if kp[i] != Shard(2)]
    if apart and len(apart) != len(split):
        raise ValueError(f"query heads at {q.placements}, kv heads at {k.placements}")
    coord = mesh.get_coordinate()
    rank = 0  # this rank's index among the query heads' shards, major to minor
    for i in split:
        rank = rank * mesh.size(i) + coord[i]
    G = cfg.n_heads // cfg.n_kv_heads

    def body(q, k, v, *extra):
        if apart:
            lo, n = rank * q.shape[2], q.shape[2]
            kv_lo, kv_hi = lo // G, (lo + n - 1) // G + 1
            if n % (kv_hi - kv_lo):
                raise ValueError(f"{n} query heads a rank do not group over {kv_hi - kv_lo} kv heads")
            k, v = k[:, :, kv_lo:kv_hi], v[:, :, kv_lo:kv_hi]
        return attend(q, k, v, *extra)

    kv_grad = tuple(Partial() if i in apart else p for i, p in enumerate(kp))
    held = tuple(lies(t) if isinstance(t, DTensor) else None for t in extra)
    return local_map(
        body, out_placements=list(qp), in_placements=(qp, kp, kp) + held,
        in_grad_placements=(qp, kv_grad, kv_grad) + held, device_mesh=mesh,
        redistribute_inputs=True,
    )(q, k, v, *extra)


def _gather_fsdp(lp, cfg: ModelConfig):
    """ZeRO-3-style weight gathering: constrain this layer's weights to their
    TP-only sharding (drop the FSDP 'data' axis) right before use, so the
    (small) weights are all-gathered once instead of the (large) partially
    contracted activations all-reduced.  A no-op with no mesh set."""

    def fix(ax, leaf):
        return constrain(leaf, *ax[1:])  # strip the stacked 'layers' axis

    return map_axes(fix, serve_overlay(param_logical_axes(cfg))["layers"], lp)


def _layer_input(x, cfg: ModelConfig):
    """A layer's residual input, gathered over the sequence where
    ``cfg.seq_shard_residual`` keeps it split between layers (sequence
    parallelism: gathered at a layer's entry, split again at its exit);
    DTensor multiplies a sequence-split activation by a weight through a
    strided split that fake tensors cannot follow."""
    return constrain(x, "batch", "seq", "embed") if cfg.seq_shard_residual else x


def _residual_axes(cfg: ModelConfig) -> tuple:
    """The residual stream's logical axes between layers: sequence-parallel
    (over 'model') with ``cfg.seq_shard_residual``."""
    if cfg.seq_shard_residual:
        return ("batch", "seq_shard", "embed")
    return ("batch", "seq", "embed")


def _ffn(lp, h, cfg: ModelConfig, ep_group=None):
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.moe is not None:
        out, aux = L.moe_layer(lp["moe"], h, cfg, ep_group)
        if cfg.moe.n_shared_experts:
            out = out + L.mlp(lp["shared_mlp"], h, cfg.act)
    elif "mlp" in lp:
        out = L.mlp(lp["mlp"], h, cfg.act)
    else:  # no FFN sub-block (pure-Mamba archs)
        out = torch.zeros_like(h)
    return out, aux


def _reduced(x):
    """The residual ``x + mix``, which the attention's out-projection leaves
    partial over 'model', reduced to replicated over each mesh dim whose
    size the local batch does not divide (the multi-pod mesh's 'model': 8
    rows a (pod, data) shard, 16 ranks).  Left partial there, DTensor
    reduce-scatters it over the sequence at the norm, and a (B S) flatten of
    that split is a strided split (``_StridedShard``) that a weight-gradient
    product cannot follow under fake tensors.  Where the batch divides,
    DTensor's own reduction (a reduce-scatter over the batch) stands."""
    if not isinstance(x, DTensor):
        return x
    mesh, held = x.device_mesh, lies(x)
    rows = x.shape[0]
    for i, p in enumerate(held):
        if p == Shard(0):
            rows //= mesh.size(i)
    keep = tuple(Replicate() if p.is_partial() and rows % mesh.size(i) else p
                 for i, p in enumerate(held))
    return x if keep == held else x.redistribute(mesh, keep)


def _residual(lp, x, h, mix, cfg: ModelConfig, ep_group=None):
    """The block's FFN and residuals around the mixer's output ``mix``."""
    if cfg.parallel_block:
        # command-r style: MLP on the same normalized input, single residual
        ff, aux = _ffn(lp, h, cfg, ep_group)
        return x + mix + ff, aux
    x = _reduced(x + mix)
    ff, aux = _ffn(lp, L.apply_norm(cfg.norm, x, lp["ln2"]), cfg, ep_group)
    return x + ff, aux


def _mix(cfg: ModelConfig, attn_out, ssm_out):
    """The token mixer's output: attention, the SSM, or (hybrid, Hymba's
    parallel heads) their mean."""
    if cfg.layer_kind == "attn":
        return attn_out
    if cfg.layer_kind == "mamba":
        return ssm_out
    return 0.5 * (attn_out + ssm_out)


def _layer_fwd(lp, x, cfg: ModelConfig, positions, ep_group=None):
    """One decoder layer (train/prefill).  Returns (y, aux_loss)."""
    if cfg.gather_weights:
        lp = _gather_fsdp(lp, cfg)
    x = _layer_input(x, cfg)
    h = L.apply_norm(cfg.norm, x, lp["ln1"])
    attn_out = ssm_out = None
    if cfg.layer_kind in ("attn", "hybrid"):
        attn_out, _ = _attn_branch(lp, h, cfg, positions, cfg.sliding_window)
    if cfg.layer_kind in ("mamba", "hybrid"):
        ssm_out = L.mamba_block(lp["ssm"], h, cfg)
    return _residual(lp, x, h, _mix(cfg, attn_out, ssm_out), cfg, ep_group)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _on(t, dtype, device) -> torch.Tensor:
    """``t`` (a tensor or array) as a tensor on ``device``."""
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=dtype or t.dtype)
    return torch.as_tensor(np.asarray(t), device=device, dtype=dtype)


def embed_inputs(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """tokens and/or precomputed frontend embeddings -> (B, S, d)."""
    table = params["embed"]["tokens"]
    parts = []
    if "frontend_embeds" in batch:  # vlm/audio stub: modality frontend output
        parts.append(_on(batch["frontend_embeds"], _dtype(cfg.dtype), table.device))
    if "tokens" in batch:
        parts.append(_lookup(table, _on(batch["tokens"], torch.int64, table.device)))
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def _lookup(table, ids):
    """``table[ids]``.  For a DTensor table, each rank looks its ids up in
    the vocab rows it holds (``local_map``): the table's vocab split is
    kept over the mesh dims that do not split the ids, its feature split
    (the FSDP 'data' axis) gathered, and a rank's rows give a partial sum
    (each id found on one rank, zeros elsewhere, so the sum is exact); the
    ids keep their batch split, and the table's gradient is a partial sum
    over the dims that split them.  DTensor's own index rule takes no id
    split over two mesh dims (the multi-pod batch) in every torch."""
    if not isinstance(table, DTensor):
        return table[ids]
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    held = lies(ids) if isinstance(ids, DTensor) else (Replicate(),) * mesh.ndim
    rows = tuple(Shard(0) if p == Shard(0) and not isinstance(q, Shard) else Replicate()
                 for p, q in zip(lies(table), held))
    split = [i for i, p in enumerate(rows) if p == Shard(0)]
    coord, rank = mesh.get_coordinate(), 0
    for i in split:
        rank = rank * mesh.size(i) + coord[i]
    out = tuple(Partial() if i in split else q for i, q in enumerate(held))

    def body(table, ids):
        n = table.shape[0]
        local = ids - rank * n
        mine = (local >= 0) & (local < n)
        return table[local.clamp(0, n - 1)] * mine[..., None].to(table.dtype)

    # the table's gradient: a partial sum over the mesh dims that split the ids
    grad = tuple(Partial() if isinstance(q, Shard) else p for p, q in zip(rows, held))
    return local_map(body, out_placements=list(out), in_placements=(rows, held),
                     in_grad_placements=(grad, held), device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)


def _unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    table = params["embed"]["tokens"].T if cfg.tie_embeddings else params["unembed"]
    return x @ table


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of plain (non-batched) matrix products, recompute the rest
    (batched products, K3's expert products, everything elementwise)."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = ("nothing", "dots", "none")


def _remat_body(cfg: ModelConfig):
    """``_layer_fwd`` under ``cfg.remat_policy``'s activation checkpointing:
    ``"nothing"`` saves only each layer's inputs and recomputes the layer in
    the backward; ``"dots"`` saves the plain matrix products' outputs too;
    ``"none"`` saves everything."""
    policy = cfg.remat_policy
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} not in {REMAT_POLICIES}")
    if policy == "none":
        return _layer_fwd
    kw = {"use_reentrant": False}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, _layer_fwd, **kw)


def forward(
    params: dict,
    cfg: ModelConfig,
    batch: dict,
    remat: bool = True,
    ep_group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), aux_loss).  With ``remat`` and autograd
    recording, each layer is checkpointed by ``cfg.remat_policy``
    (``_remat_body``); the values are the same either way.  ``ep_group`` (a
    ``torch.distributed`` group) runs the MoE layers expert-parallel over
    its ranks, ``params`` holding this rank's experts
    (``convert.expert_shard``); every rank returns the same logits.

    Under an ambient mesh (``sharding.set_mesh``) the parameters and the
    batch are DTensors (``sharding.distribute_params``,
    ``batch_sharding``), the activations are constrained where the
    reference constrains them, and the logits come back as a DTensor."""
    with mesh_ops():
        x = constrain(embed_inputs(params, cfg, batch), "batch", "seq", "embed")
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        body = _remat_body(cfg) if remat and torch.is_grad_enabled() else _layer_fwd
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in layer_slices(params):
            x, a = body(lp, x, cfg, positions, ep_group)
            x = constrain(x, *_residual_axes(cfg))
            aux = aux + a
        x = L.apply_norm(cfg.norm, x, params["final_norm"])
        return constrain(_unembed(params, cfg, x), "batch", "seq", "vocab"), aux


def train_loss(params: dict, cfg: ModelConfig, batch: dict, remat: bool = True):
    """(loss, {"nll", "aux"}): the mean next-token negative log-likelihood
    of ``batch["labels"]`` (fp32 log-softmax; labels < 0 masked; the last
    ``S_lab`` positions, after any frontend positions) plus the MoE aux
    loss, as the reference's ``train_loss``."""
    with mesh_ops():
        logits, aux = forward(params, cfg, batch, remat=remat)
        labels = _on(batch["labels"], torch.int64, logits.device)
        mask = labels >= 0
        S_lab = labels.shape[1]
        if isinstance(logits, DTensor):
            token_logp = _sharded_label_logp(logits[:, -S_lab:], labels.clamp(min=0))
        else:
            logp = torch.log_softmax(logits.float(), dim=-1)
            token_logp = logp[:, -S_lab:].gather(-1, labels.clamp(min=0)[..., None])[..., 0]
        nll = -(token_logp * mask).sum() / mask.sum().clamp(min=1)
        return nll + aux, {"nll": nll, "aux": aux}


def _sharded_label_logp(logits, labels):
    """fp32 ``log_softmax(logits)[label]`` of DTensor logits, as the
    reference's ``take_along_axis`` under GSPMD keeps it: the logits stay
    split over the vocab (their max and sum of exponentials are reduced
    across it) and each rank picks the labels its vocab shard holds."""
    from torch.distributed.tensor import distribute_tensor

    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()  # a shift: lse's gradient is free of it
    lse = m + (lf - m).exp().sum(dim=-1, keepdim=True).log()
    # the vocab ids, split as the logits' last dim is
    placements = [Shard(0) if p == Shard(lf.ndim - 1) else Replicate() for p in lies(lf)]
    ids = torch.arange(lf.shape[-1], device=lf.device_mesh.device_type)
    ids = distribute_tensor(ids, lf.device_mesh, placements, src_data_rank=None)
    picked = (lf * (labels[..., None] == ids)).sum(dim=-1)
    return picked - lse[..., 0]


# ---------------------------------------------------------------------------
# prefill (serve) path: forward + cache construction
# ---------------------------------------------------------------------------
def _ring_align(x: torch.Tensor, S: int, C: int, axis: int) -> torch.Tensor:
    """Trim the last C of S positions and rotate so position p sits at ring
    slot p % C (matches decode's ``slot = pos % C``)."""
    trimmed = x.narrow(axis, S - C, C)
    shift = (S - C) % C
    return torch.roll(trimmed, shift, dims=axis) if shift else trimmed


def prefill_step(
    params: dict,
    cfg: ModelConfig,
    batch: dict,
    ep_group=None,
) -> tuple[torch.Tensor, dict]:
    """Run the full prompt, return (last-token logits (B, V), cache).

    Attention layers fill a KV ring of C = ``kv_cache_len(cfg, S)`` slots;
    with no sliding window C = S, so the first decode step after it
    overwrites the oldest position, as in the reference.  SSM layers keep
    the tail of their pre-convolution input (``"conv"``) and their last
    state (``"h"``, fp32).  The cache holds the reference's keys for the
    config's ``layer_kind``, each stacked over the layers.  ``ep_group`` as
    in ``forward``; under an ambient mesh, as ``forward``, with the cache
    constrained to ``sharding.cache_logical_axes``."""
    with mesh_ops():
        return _prefill(params, cfg, batch, ep_group)


def _prefill(params: dict, cfg: ModelConfig, batch: dict, ep_group):
    x = constrain(embed_inputs(params, cfg, batch), "batch", "seq", "embed")
    B, S, _ = x.shape
    C = kv_cache_len(cfg, S)
    dev = x.device
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    entries: dict[str, list] = {}
    for lp in layer_slices(params):
        if cfg.gather_weights:
            lp = _gather_fsdp(lp, cfg)
        x = _layer_input(x, cfg)
        h = L.apply_norm(cfg.norm, x, lp["ln1"])
        attn_out = ssm_out = None
        if cfg.layer_kind in ("attn", "hybrid"):
            attn_out, (k, v) = _attn_branch(lp, h, cfg, positions, cfg.sliding_window)
            entries.setdefault("k", []).append(_ring_align(k, S, C, axis=1))
            entries.setdefault("v", []).append(_ring_align(v, S, C, axis=1))
        if cfg.layer_kind in ("mamba", "hybrid"):
            ssm_out, conv_tail, h_last = L.mamba_block_with_state(lp["ssm"], h, cfg)
            entries.setdefault("conv", []).append(conv_tail)
            entries.setdefault("h", []).append(h_last)
        x, _ = _residual(lp, x, h, _mix(cfg, attn_out, ssm_out), cfg, ep_group)
        x = constrain(x, *_residual_axes(cfg))
    x = L.apply_norm(cfg.norm, x[:, -1:], params["final_norm"])
    logits = constrain(_unembed(params, cfg, x), "batch", "seq", "vocab")[:, 0]
    cache = {"pos": torch.full((), S, dtype=torch.int32, device=dev)}
    cache.update((key, torch.stack(per_layer)) for key, per_layer in entries.items())
    if "k" in cache:
        cache_pos = _ring_align(torch.arange(S, dtype=torch.int32, device=dev), S, C, axis=0)
        cache["cache_pos"] = cache_pos[None].repeat(cfg.n_layers, 1)
    axes = cache_logical_axes(cfg)
    return logits, {key: constrain(t, *axes[key]) for key, t in cache.items()}


# ---------------------------------------------------------------------------
# decode (serve) path
# ---------------------------------------------------------------------------
def kv_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    return min(cfg.sliding_window, seq_len) if cfg.sliding_window else seq_len


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None, device=None) -> dict:
    """Cache tree.  Attention: ring-buffer K/V (window-capped).  SSM:
    (conv_state, h).  Hybrid: both.  On the card unless ``device`` names
    another (``"meta"`` for shapes alone)."""
    device = torch.device("meta") if device == "meta" else resolve_device(device)
    dt = _dtype(dtype or cfg.dtype)
    C = kv_cache_len(cfg, seq_len)
    Ln = cfg.n_layers
    cache: dict = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.layer_kind in ("attn", "hybrid"):
        kv = (Ln, batch, C, cfg.n_kv_heads, cfg.head_dim)
        cache["k"] = torch.zeros(kv, dtype=dt, device=device)
        cache["v"] = torch.zeros(kv, dtype=dt, device=device)
        cache["cache_pos"] = torch.full((Ln, C), -1, dtype=torch.int32, device=device)
    if cfg.layer_kind in ("mamba", "hybrid"):
        ssm = cfg.ssm
        Kc = ssm.d_conv if ssm else 4
        N = ssm.d_state if ssm else 16
        cache["conv"] = torch.zeros((Ln, batch, Kc - 1, cfg.d_inner), dtype=dt, device=device)
        cache["h"] = torch.zeros((Ln, batch, cfg.d_inner, N), dtype=torch.float32, device=device)
    return cache


_KV_AXES = {
    "none": None,
    "batch": ("batch", None, "kv_heads", "head_dim"),
    "seq": ("batch", "kv_seq", "kv_heads", "head_dim"),
}


def _pinned(t, kv_axes, what: str):
    """The reference's ``pin``: ``t`` constrained to ``kv_axes``
    (``cfg.kv_shard_mode``).  A cache layer is updated in place, so it must
    already lie so (distributed by ``sharding.fit_sharding_tree(cache,
    cache_logical_axes(cfg), mesh)``, as ``prefill_step`` returns it): one
    that does not raises rather than being regathered."""
    if kv_axes is None:
        return t
    pinned = constrain(t, *kv_axes)
    if what == "cache" and pinned is not t:
        raise ValueError(
            f"a KV cache layer at {t.placements}, not at kv_shard_mode's placements "
            f"{pinned.placements}: distribute the cache by sharding.cache_logical_axes"
        )
    return pinned


def _attn_decode(lp, h, cache: dict, i: int, cfg: ModelConfig, pos):
    """The attention branch of one token; writes its K/V into layer ``i``
    of ``cache`` in place (slot ``pos % C``, with no host sync)."""
    kv_axes = _KV_AXES[cfg.kv_shard_mode]
    k_cache = _pinned(cache["k"][i], kv_axes, "cache")
    v_cache = _pinned(cache["v"][i], kv_axes, "cache")
    cache_pos = cache["cache_pos"][i]
    C = k_cache.shape[1]
    q, k, v = _qkv(lp, h, cfg, pos.view(1, 1).expand(h.shape[0], 1))
    # (the query's heads split as prefill splits them: each rank attends its own)
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k, v = _pinned(k, kv_axes, "entry"), _pinned(v, kv_axes, "entry")
    slot = torch.remainder(pos, C).view(1).long()
    if isinstance(k_cache, DTensor):
        _write_slot(k_cache, slot, k)
        _write_slot(v_cache, slot, v)
    else:
        k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
        v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    _local_whole(cache_pos).index_copy_(0, _local_whole(slot),
                                        _local_whole(pos).view(1).to(cache_pos.dtype))
    if not isinstance(q, DTensor):
        o = L.decode_attention(q, k_cache, v_cache, cache_pos, pos, cfg.sliding_window)
    elif _slots_split(k_cache):
        o = _split_slots_attention(q, k_cache, v_cache, cache_pos, pos, cfg)
    else:
        o = _by_heads(q, k_cache, v_cache, cfg, functools.partial(
            L.decode_attention, window=cfg.sliding_window), cache_pos, pos)
    return _out_project(o, lp["attn"]["wo"])


def _local_whole(t):
    """A replicated DTensor's local tensor, which is the whole of it (an
    in-place write there is the same write on every rank); any other
    tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    if not all(p.is_replicate() for p in t.placements):
        raise ValueError(f"a write in place into a split DTensor ({t.placements})")
    return t.to_local()


def _copy_into(dst, src) -> None:
    """``dst.copy_(src)`` in place; for a DTensor ``dst``, into its shard,
    ``src`` first redistributed to ``dst``'s placements."""
    if isinstance(dst, DTensor):
        dst.to_local().copy_(src.redistribute(dst.device_mesh, lies(dst)).to_local())
    else:
        dst.copy_(src)


def _slots_split(cache) -> list[int]:
    """The mesh dims that split a DTensor KV cache layer's slots
    (``kv_shard_mode`` "seq")."""
    return [i for i, p in enumerate(lies(cache)) if p == Shard(1)]


def _local_slots(cache) -> tuple[torch.Tensor, int]:
    """This rank's shard of a DTensor cache layer and the first slot it holds."""
    mesh, coord, rank = cache.device_mesh, cache.device_mesh.get_coordinate(), 0
    for i in _slots_split(cache):
        rank = rank * mesh.size(i) + coord[i]
    local = cache.to_local()
    return local, rank * local.shape[1]


def _write_slot(cache, slot, entry) -> None:
    """``cache[:, slot] = entry[:, 0]`` in place on a DTensor cache layer,
    each rank on its own shard (DTensor's in-place ``index_copy_`` would
    gather a slot-split layer into a copy): the rank holding the slot
    writes it, the others write back what they hold."""
    from torch.distributed.tensor import Replicate

    mesh = cache.device_mesh
    entry = entry.redistribute(mesh, [Replicate() if p == Shard(1) else p
                                      for p in lies(cache)]).to_local()
    local, lo = _local_slots(cache)
    slot = slot.to_local() if isinstance(slot, DTensor) else slot
    entry = entry.to(local.dtype)
    if _slots_split(cache):
        n = local.shape[1]
        mine = (slot >= lo) & (slot < lo + n)
        slot = (slot - lo).clamp(0, n - 1)
        entry = torch.where(mine.view(1, 1, 1, 1), entry, local.index_select(1, slot))
    local.index_copy_(1, slot, entry)


def _split_slots_attention(q, k_cache, v_cache, cache_pos, pos, cfg: ModelConfig):
    """One token's attention over a cache layer whose slots are split over
    mesh dims (the reference's distributed flash-decode): each rank scores
    its slots with every query head (``L.decode_scores``), the softmax's
    max and sum are reduced across the slot shards, and each shard's
    weighted values are summed across them in fp32 and rounded once to
    the cache's type, as ``L.decode_attention``'s one product rounds once
    (all-reduces on those dims' groups)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = k_cache.device_mesh
    groups = [mesh.get_group(i) for i in _slots_split(k_cache)]
    kp = lies(k_cache)
    qp = tuple(Shard(0) if p == Shard(0) else Replicate() for p in kp)
    _, lo = _local_slots(k_cache)

    def body(q, k, v, cache_pos, cur_pos):
        B, _, H, Dh = q.shape
        s = L.decode_scores(q, k, cache_pos[lo:lo + k.shape[1]], cur_pos, cfg.sliding_window)
        m = s.amax(dim=-1, keepdim=True)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        for g in groups:
            dist.all_reduce(l, group=g)
        p = (p / l).to(v.dtype)
        out = torch.einsum("bhgc,bchd->bhgd", p.float(), v.float())
        for g in groups:
            dist.all_reduce(out, group=g)
        return out.to(v.dtype).reshape(B, 1, H, Dh)

    extra = tuple(lies(t) if isinstance(t, DTensor) else None for t in (cache_pos, pos))
    return local_map(body, out_placements=list(qp), in_placements=(qp, kp, kp) + extra,
                     device_mesh=mesh, redistribute_inputs=True)(q, k_cache, v_cache,
                                                                 cache_pos, pos)


def _ssm_decode(lp, h, cache: dict, i: int, cfg: ModelConfig):
    """The SSM branch of one token; writes its conv tail and state into
    layer ``i`` of ``cache`` in place."""
    conv, state = cache["conv"][i], cache["h"][i]
    out, new_conv, new_state = L.mamba_decode_step(lp["ssm"], h, conv, state, cfg)
    _copy_into(conv, new_conv)
    _copy_into(state, new_state)
    return out


def _layer_decode(lp, x, cache: dict, i: int, cfg: ModelConfig, pos, ep_group=None):
    """One layer, one token, updating layer ``i`` of ``cache`` in place."""
    h = L.apply_norm(cfg.norm, x, lp["ln1"])
    attn_out = ssm_out = None
    if cfg.layer_kind in ("attn", "hybrid"):
        attn_out = _attn_decode(lp, h, cache, i, cfg, pos)
    if cfg.layer_kind in ("mamba", "hybrid"):
        ssm_out = _ssm_decode(lp, h, cache, i, cfg)
    return _residual(lp, x, h, _mix(cfg, attn_out, ssm_out), cfg, ep_group)[0]


def decode_step(
    params: dict,
    cfg: ModelConfig,
    cache: dict,
    tokens,  # (B, 1) current token ids
    ep_group=None,
) -> tuple[torch.Tensor, dict]:
    """One serve step: returns (logits (B, V), cache).

    Unlike the reference, which returns a new cache, this updates
    ``cache``'s tensors (K/V, the SSM's conv tail and state) in place and
    returns the same dict with ``"pos"`` advanced by one: a caller that
    needs the old cache copies it first.  ``ep_group`` as in ``forward``:
    the MoE layers run expert-parallel at this step's T = B tokens, each
    rank's pairs at the global capacity, as the reference's ``_moe_ep``
    under a mesh with a ``model`` axis.  The one-process step never waits
    for the card; over gloo, each MoE layer's combine is staged through
    the host (``comm._on_host``), so the step waits there, once a layer.
    Under an ambient mesh the parameters, the cache
    (by ``sharding.cache_logical_axes``) and the tokens are DTensors, each KV
    cache layer pinned by ``cfg.kv_shard_mode``, as in the reference."""
    with mesh_ops():
        table = params["embed"]["tokens"]
        x = _lookup(table, _on(tokens, torch.int64, table.device))
        pos = cache["pos"]
        for i, lp in enumerate(layer_slices(params)):
            x = _layer_decode(lp, x, cache, i, cfg, pos, ep_group)
        x = L.apply_norm(cfg.norm, x, params["final_norm"])
        logits = constrain(_unembed(params, cfg, x), "batch", "seq", "vocab")[:, 0]
        cache["pos"] = pos + 1
        return logits, cache
