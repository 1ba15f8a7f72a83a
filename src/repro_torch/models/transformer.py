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
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch._device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


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
def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
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
    o = L.chunked_attention(q, k, v, window=window)
    return _out_project(o, lp["attn"]["wo"]), (k, v)


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


def _residual(lp, x, h, mix, cfg: ModelConfig, ep_group=None):
    """The block's FFN and residuals around the mixer's output ``mix``."""
    if cfg.parallel_block:
        # command-r style: MLP on the same normalized input, single residual
        ff, aux = _ffn(lp, h, cfg, ep_group)
        return x + mix + ff, aux
    x = x + mix
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
        parts.append(table[_on(batch["tokens"], torch.int64, table.device)])
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


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
    (``convert.expert_shard``); every rank returns the same logits."""
    x = embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    body = _remat_body(cfg) if remat and torch.is_grad_enabled() else _layer_fwd
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_slices(params):
        x, a = body(lp, x, cfg, positions, ep_group)
        aux = aux + a
    x = L.apply_norm(cfg.norm, x, params["final_norm"])
    return _unembed(params, cfg, x), aux


def train_loss(params: dict, cfg: ModelConfig, batch: dict, remat: bool = True):
    """(loss, {"nll", "aux"}): the mean next-token negative log-likelihood
    of ``batch["labels"]`` (fp32 log-softmax; labels < 0 masked; the last
    ``S_lab`` positions, after any frontend positions) plus the MoE aux
    loss, as the reference's ``train_loss``."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    labels = _on(batch["labels"], torch.int64, logits.device)
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = labels >= 0
    S_lab = labels.shape[1]
    token_logp = logp[:, -S_lab:].gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    nll = -(token_logp * mask).sum() / mask.sum().clamp(min=1)
    return nll + aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# prefill (serve) path: forward + cache construction
# ---------------------------------------------------------------------------
def _ring_align(x: torch.Tensor, S: int, C: int, axis: int) -> torch.Tensor:
    """Trim the last C of S positions and rotate so position p sits at ring
    slot p % C (matches decode's ``slot = pos % C``)."""
    trimmed = x.narrow(axis, S - C, C)
    return torch.roll(trimmed, (S - C) % C, dims=axis)


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
    in ``forward``."""
    x = embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    C = kv_cache_len(cfg, S)
    dev = x.device
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    entries: dict[str, list] = {}
    for lp in layer_slices(params):
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
    x = L.apply_norm(cfg.norm, x[:, -1:], params["final_norm"])
    logits = _unembed(params, cfg, x)[:, 0]
    cache = {"pos": torch.full((), S, dtype=torch.int32, device=dev)}
    cache.update((key, torch.stack(per_layer)) for key, per_layer in entries.items())
    if "k" in cache:
        cache_pos = _ring_align(torch.arange(S, dtype=torch.int32, device=dev), S, C, axis=0)
        cache["cache_pos"] = cache_pos[None].repeat(cfg.n_layers, 1)
    return logits, cache


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


def _attn_decode(lp, h, cache: dict, i: int, cfg: ModelConfig, pos):
    """The attention branch of one token; writes its K/V into layer ``i``
    of ``cache`` in place (slot ``pos % C``, with no host sync)."""
    k_cache, v_cache, cache_pos = cache["k"][i], cache["v"][i], cache["cache_pos"][i]
    C = k_cache.shape[1]
    q, k, v = _qkv(lp, h, cfg, pos.view(1, 1).expand(h.shape[0], 1))
    slot = torch.remainder(pos, C).view(1).long()
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    cache_pos.index_copy_(0, slot, pos.view(1).to(cache_pos.dtype))
    o = L.decode_attention(q, k_cache, v_cache, cache_pos, pos, cfg.sliding_window)
    return _out_project(o, lp["attn"]["wo"])


def _ssm_decode(lp, h, cache: dict, i: int, cfg: ModelConfig):
    """The SSM branch of one token; writes its conv tail and state into
    layer ``i`` of ``cache`` in place."""
    conv, state = cache["conv"][i], cache["h"][i]
    out, new_conv, new_state = L.mamba_decode_step(lp["ssm"], h, conv, state, cfg)
    conv.copy_(new_conv)
    state.copy_(new_state)
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
    the host (``comm._on_host``), so the step waits there, once a layer."""
    table = params["embed"]["tokens"]
    x = table[_on(tokens, torch.int64, table.device)]
    pos = cache["pos"]
    for i, lp in enumerate(layer_slices(params)):
        x = _layer_decode(lp, x, cache, i, cfg, pos, ep_group)
    x = L.apply_norm(cfg.norm, x, params["final_norm"])
    logits = _unembed(params, cfg, x)[:, 0]
    cache["pos"] = pos + 1
    return logits, cache
