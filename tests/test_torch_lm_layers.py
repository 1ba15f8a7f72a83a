"""The port's LM layers against the JAX package's on the CPU, in fp32 at
smoke size: a sliding window through prefill and decode, the chunked and
decode attention alone, an MoE with a planner placement installed, an MoE
whose capacity drops pairs, the expert products on K3 with tiles that
divide, and prefill against token-by-token decode on an MoE, within 1e-4;
and the MoE layer in bf16 within the repo's bf16 rule."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jax_layers
import repro.models.transformer as jax_tf
import repro_torch.configs as configs
import repro_torch.kernels.moe_gemm as k3
import repro_torch.models.layers as layers
import repro_torch.models.transformer as tf
from repro_torch.core.moe_planner import plan_expert_placement, routing_counts
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.training import make_decode_step, make_prefill_step
from test_torch_lm import TOL, _batch, _cfgs, _close, _params, _serve_both


@pytest.mark.parametrize("window", [16, 48])
def test_sliding_window_equals_jax(window):
    """A ring of ``window`` slots (prefill trims and rotates it), decode
    steps wrapping round it."""
    jcfg, tcfg = _cfgs("internlm2-1.8b", sliding_window=window)
    jp, tp = _params(jcfg)
    cache = _serve_both(jcfg, tcfg, jp, tp, _batch(tcfg), steps=4)
    assert cache["k"].shape[2] == window
    jlog, _ = jax_tf.forward(jp, jcfg, {"tokens": jnp.asarray(_batch(tcfg)["tokens"])})
    _close(tf.forward(tp, tcfg, _batch(tcfg))[0], jlog, "windowed forward")


@pytest.mark.parametrize("window", [0, 8, 20])
@pytest.mark.parametrize("chunks", [(16, 16), (8, 32), (64, 64)])
def test_chunked_attention_equals_jax(chunks, window):
    """Several chunks each way: the chunks the port skips (wholly in a
    query chunk's future, or past its window) change nothing."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 64, 2, 16)).astype(np.float32) for _ in range(2))
    want = jax_layers.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        window, *chunks)
    got = layers.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), window, *chunks)
    _close(got, want)


def test_chunked_attention_refuses_chunks_that_do_not_divide_as_jax():
    q = torch.zeros((1, 48, 2, 8))
    with pytest.raises(ValueError, match="not divisible"):
        layers.chunked_attention(q, q, q, q_chunk=32, kv_chunk=32)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_equals_jax(window):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 12, 2, 16)).astype(np.float32) for _ in range(2))
    cache_pos = np.array([8, 9, 10, -1, 4, 5, 6, 7, 12, -1, 2, 3], np.int32)
    want = jax_layers.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                       jnp.asarray(cache_pos), jnp.asarray(10, jnp.int32), window)
    got = layers.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc, cache_pos)),
                                  torch.tensor(10, dtype=torch.int32), window)
    _close(got, want)


def _moe_out_both(jcfg, tcfg, jp, tp, x):
    lp_j = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    lp_t = tf.layer_slices(tp)[0]["moe"]
    jout, jaux = jax_layers.moe_layer(lp_j, jnp.asarray(x), jcfg)
    tout, taux = layers.moe_layer(lp_t, torch.from_numpy(x), tcfg)
    _close(tout, jout, "moe out")
    _close(taux, jaux, "moe aux")


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "dbrx-132b"])
def test_moe_with_a_planner_placement_equals_jax(arch):
    """The placement of ``core.moe_planner`` installed in the config
    permutes the routed experts in both packages."""
    base = configs.get_smoke_config(arch).moe
    E, K = base.n_experts, base.top_k
    rng = np.random.default_rng(0)
    scattered = rng.permutation(E).reshape(2, E // 2)
    gate = np.stack([rng.choice(scattered[(t * 2) // 512], size=K, replace=False)
                     for t in range(512)])
    plan = plan_expert_placement(routing_counts(gate, E, 16), n_columns=2)
    placement = tuple(int(e) for e in plan.placement)
    assert placement != tuple(range(E))
    jcfg, tcfg = _cfgs(arch, moe={"expert_placement": placement})
    jp, tp = _params(jcfg)
    batch = _batch(tcfg)
    jlog, jaux = jax_tf.forward(jp, jcfg, {"tokens": jnp.asarray(batch["tokens"])})
    tlog, taux = tf.forward(tp, tcfg, batch)
    _close(tlog, jlog, "logits")
    _close(taux, jaux, "aux")
    plain_log, _ = tf.forward(tp, configs.get_smoke_config(arch), batch)
    assert not torch.allclose(plain_log, tlog, rtol=TOL, atol=TOL)
    _serve_both(jcfg, tcfg, jp, tp, batch)


def test_moe_dropping_pairs_equals_jax():
    """At capacity factor 0.5 every expert has room for half its fair share
    of pairs, so the stable sort decides which pairs each full expert drops."""
    jcfg, tcfg = _cfgs("qwen3-moe-235b-a22b", moe={"capacity_factor": 0.5})
    jp, tp = _params(jcfg)
    x = np.random.default_rng(5).standard_normal((2, 64, tcfg.d_model)).astype(np.float32)
    # the layer keeps fewer pairs than were routed
    moe = tcfg.moe
    T, E, K = 128, moe.n_experts, moe.top_k
    cap = int(np.ceil(T * K / E * moe.capacity_factor))
    probs = torch.softmax(torch.from_numpy(x).reshape(T, -1) @ tf.layer_slices(tp)[0]["moe"]["router"], -1)
    routed = torch.bincount(torch.topk(probs, K).indices.reshape(-1), minlength=E)
    assert int(torch.clamp(routed, max=cap).sum()) < T * K
    _moe_out_both(jcfg, tcfg, jp, tp, x)
    batch = _batch(tcfg)
    jlog, _ = jax_tf.forward(jp, jcfg, {"tokens": jnp.asarray(batch["tokens"])})
    _close(tf.forward(tp, tcfg, batch)[0], jlog, "logits")


BF16_TOL = 2e-2  # chip_smoke.py's bf16 rule: |got - want| <= 2e-2 + 2e-2 |want|


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "dbrx-132b"])
def test_moe_in_bf16_within_the_bf16_rule_of_jax(arch):
    """In bf16 the port's combine sums a token's K contributions, each
    rounded to bf16 as the reference rounds it, in fp32 and rounds once;
    the reference sums them in bf16.  The layer's output stays within the
    repo's bf16 rule of the reference's on the same bf16 weights and input."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    jp, tp = _params(jcfg)
    assert tf.layer_slices(tp)[0]["moe"]["wi"].dtype == torch.bfloat16
    x = np.random.default_rng(6).standard_normal((2, 64, tcfg.d_model)).astype(np.float32)
    lp_j = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    jout, jaux = jax_layers.moe_layer(lp_j, jnp.asarray(x, jnp.bfloat16), jcfg)
    tout, taux = layers.moe_layer(tf.layer_slices(tp)[0]["moe"],
                                  torch.from_numpy(x).bfloat16(), tcfg)
    assert tout.dtype == torch.bfloat16
    want = np.asarray(jout.astype(jnp.float32))
    got = tout.float().numpy()
    assert np.all(np.abs(got - want) <= BF16_TOL + BF16_TOL * np.abs(want)), \
        np.abs(got - want).max()
    _close(taux, jaux, "moe aux")


def test_moe_experts_run_on_k3_with_whole_dim_tiles(monkeypatch):
    """Three grouped GEMMs a layer, each with tiles that divide its dims
    (160 rows would not divide the TPU tiles' 128)."""
    calls = []

    def spy(x, w, b_c=128, b_f=128, b_d=512):
        calls.append((tuple(x.shape), tuple(w.shape), (b_c, b_f, b_d)))
        return moe_gemm(x, w, b_c, b_f, b_d)

    monkeypatch.setattr(k3, "moe_gemm", spy)
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-moe-235b-a22b"), n_layers=2)
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator().manual_seed(0))
    params = tf.init_params(cfg, 0, device="cpu")
    layers.moe_layer(tf.layer_slices(params)[0]["moe"], x, cfg)
    E, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
    cap = int(np.ceil(80 * cfg.moe.top_k / E * cfg.moe.capacity_factor))
    assert cap % 8 and calls == [((E, cap, 64), (E, 64, f), (cap, f, 64))] * 2 + [
        ((E, cap, f), (E, f, 64), (cap, 64, f))]


def test_prefill_matches_token_by_token_decode_on_moe():
    """Prefill and S single-token decodes agree where nothing is dropped: at
    capacity factor E / K every expert has room for every token."""
    base = configs.get_smoke_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=base.moe.n_experts / base.moe.top_k))
    params = tf.init_params(cfg, 0, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (1, 16)).astype(np.int32)
    logits_p, _ = make_prefill_step(cfg)(params, {"tokens": toks})
    cache = tf.init_kv_cache(cfg, 1, 24, device="cpu")
    decode = make_decode_step(cfg)
    for i in range(16):
        logits_d, cache = decode(params, cache, toks[:, i:i + 1])
    torch.testing.assert_close(logits_p, logits_d, rtol=TOL, atol=TOL)
