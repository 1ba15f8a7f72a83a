"""The port's LM serving path against the JAX package's on the CPU: for each
of the ten architectures at smoke size (attention, Mamba and hybrid
layers), in fp32, with JAX's ``init_params(cfg, jax.random.key(0))``
carried across by ``params_from_reference``, ``forward``'s logits and aux
loss, ``prefill_step``'s logits and cache (KV, and the SSM's conv tail and
state), and three greedy ``decode_step``s, within 1e-4; for the SSM
architectures also prefill against token-by-token decode, and hymba's
decode steps at the ``long_500k`` shape's last positions.  The MoE layers'
expert products run K3's plain version here (``kernels.moe_gemm`` on CPU
tensors).  The layers and the MoE cases are held to JAX in
``test_torch_lm_layers.py``, the SSM in ``test_torch_mamba.py``; the
parameter trees, counts, specs and token pipeline in
``test_torch_lm_shapes.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro.models.layers as jax_layers
import repro.models.transformer as jax_tf
import repro_torch.configs as configs
import repro_torch.models.layers as layers
import repro_torch.models.transformer as tf
from repro_torch.models.convert import params_from_reference
from repro_torch.training import make_decode_step, make_prefill_step

TOL = 1e-4
ARCHS = configs.all_arch_ids()
SSM_ARCHS = [a for a in ARCHS if configs.get_smoke_config(a).layer_kind != "attn"]


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got.detach().cpu(), np.float32),
                               np.asarray(want, np.float32), rtol=TOL, atol=TOL, err_msg=what)


def _cfgs(arch, **changes):
    """(JAX config, port config) for the smoke config of ``arch``, each from
    its own package, with the same ``dataclasses.replace`` changes."""
    jcfg, tcfg = jax_configs.get_smoke_config(arch), configs.get_smoke_config(arch)
    moe = changes.pop("moe", None)
    if moe:
        changes_j = dict(changes, moe=dataclasses.replace(jcfg.moe, **moe))
        changes_t = dict(changes, moe=dataclasses.replace(tcfg.moe, **moe))
    else:
        changes_j = changes_t = changes
    return dataclasses.replace(jcfg, **changes_j), dataclasses.replace(tcfg, **changes_t)


def _params(jcfg):
    jp = jax_tf.init_params(jcfg, jax.random.key(0))
    return jp, params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(cfg, B=2, S=64, seed=0):
    rng = np.random.default_rng(seed)
    n_front = 16 if cfg.frontend == "vision" else 0
    batch = {}
    if n_front:
        batch["frontend_embeds"] = rng.standard_normal((B, n_front, cfg.d_model)).astype(np.float32)
    batch["tokens"] = rng.integers(0, cfg.vocab, (B, S - n_front)).astype(np.int32)
    return batch


def _serve_both(jcfg, tcfg, jp, tp, batch, steps=3):
    """Prefill then ``steps`` greedy decode steps in both packages, each
    step's logits and cache compared; returns the port's last cache."""
    jlog, jcache = jax_tf.prefill_step(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    tlog, tcache = make_prefill_step(tcfg)(tp, batch)
    _close(tlog, jlog, "prefill logits")
    assert sorted(tcache) == sorted(jcache)
    for k in jcache:
        assert tcache[k].dtype == getattr(torch, str(jcache[k].dtype)), k
        _close(tcache[k], jcache[k], f"prefill cache {k}")
    decode = make_decode_step(tcfg)
    for step in range(steps):
        tok = np.asarray(jlog.argmax(-1))[:, None].astype(np.int32)
        jlog, jcache = jax_tf.decode_step(jp, jcfg, jcache, jnp.asarray(tok))
        tlog, tcache = decode(tp, tcache, tok)
        _close(tlog, jlog, f"decode {step} logits")
        for k in jcache:
            _close(tcache[k], jcache[k], f"decode {step} cache {k}")
    return tcache


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    batch = _batch(tcfg)
    jlog, jaux = jax_tf.forward(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    tlog, taux = tf.forward(tp, tcfg, batch)
    assert tlog.shape == jlog.shape and tlog.dtype == torch.float32
    _close(tlog, jlog, "logits")
    _close(taux, jaux, "aux")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    cache = _serve_both(jcfg, tcfg, jp, tp, _batch(tcfg))
    assert int(cache["pos"]) == 64 + 3


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_matches_token_by_token_decode(arch):
    """The port's counterpart of ``test_arch_smoke.py::test_prefill_matches_decode``:
    prefill's last logits against S single-token decode steps from an
    empty cache, within 1e-4 (the reference's test allows 2e-2)."""
    cfg = configs.get_smoke_config(arch)
    params = tf.init_params(cfg, 0, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (1, 16)).astype(np.int32)
    logits_p, cache_p = make_prefill_step(cfg)(params, {"tokens": toks})
    cache = tf.init_kv_cache(cfg, 1, 24, device="cpu")
    decode = make_decode_step(cfg)
    for i in range(16):
        logits_d, cache = decode(params, cache, toks[:, i:i + 1])
    torch.testing.assert_close(logits_p, logits_d, rtol=TOL, atol=TOL)
    # the SSM state after the prompt is the same either way
    torch.testing.assert_close(cache_p["h"], cache["h"], rtol=TOL, atol=TOL)
    torch.testing.assert_close(cache_p["conv"], cache["conv"], rtol=TOL, atol=TOL)


def _rope_op_by_op(real):
    """The reference's ``rope_freqs`` evaluated op by op (as JAX evaluates
    it outside a trace) through a host callback, for use inside its
    ``lax.scan``."""

    def rope_freqs(d_head, theta, positions):
        def host(p):
            return tuple(np.asarray(t) for t in real(d_head, theta, jnp.asarray(p)))

        spec = jax.ShapeDtypeStruct((*positions.shape, d_head // 2), jnp.float32)
        return jax.pure_callback(host, (spec, spec), positions)

    return rope_freqs


def test_hymba_decodes_at_the_long_500k_positions_as_jax(monkeypatch):
    """hymba's decode steps from position 524,280 of a cache made by
    ``init_kv_cache(cfg, 1, 524_288)`` (``long_500k``'s shape; the window
    caps the ring at C slots), seeded with random K/V, conv tail and
    state, equal JAX's within 1e-4.  At these positions RoPE's fp32 angles
    are ill-conditioned: inside ``decode_step``'s ``lax.scan`` XLA fuses
    the frequencies' ``pow`` and the ``cos`` and moves angles near 5e5 by
    up to 8e-3 rad (cos off float64 by 1.6e-3), where op by op JAX gives
    the port's tables within an fp32 ulp.  So the reference decodes here
    with its own ``rope_freqs`` evaluated op by op."""
    real = jax_layers.rope_freqs
    positions = np.arange(524_280, 524_288, dtype=np.int32)[None]
    for t, j in zip(layers.rope_freqs(16, 10_000.0, torch.from_numpy(positions)),
                    real(16, 10_000.0, jnp.asarray(positions))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-7)
    monkeypatch.setattr(jax_layers, "rope_freqs", _rope_op_by_op(real))
    jcfg, tcfg = _cfgs("hymba-1.5b")
    jp, tp = _params(jcfg)
    jcache = jax_tf.init_kv_cache(jcfg, 1, 524_288)
    tcache = tf.init_kv_cache(tcfg, 1, 524_288, device="cpu")
    C = tcfg.sliding_window
    assert tcache["k"].shape[2] == jcache["k"].shape[2] == C
    rng = np.random.default_rng(7)
    start = 524_280
    filled = {k: rng.standard_normal(jcache[k].shape).astype(np.float32)
              for k in ("k", "v", "conv", "h")}
    # the ring holds the C positions before ``start``, slot p % C
    ring = np.arange(start - C, start)
    cache_pos = np.zeros((tcfg.n_layers, C), np.int32)
    cache_pos[:, ring % C] = ring
    filled["cache_pos"] = cache_pos
    jcache = {"pos": jnp.asarray(start, jnp.int32), **{k: jnp.asarray(v) for k, v in filled.items()}}
    tcache = {"pos": torch.tensor(start, dtype=torch.int32),
              **{k: torch.from_numpy(v.copy()) for k, v in filled.items()}}
    decode = make_decode_step(tcfg)
    tok = np.array([[3]], np.int32)
    for step in range(8):
        jlog, jcache = jax_tf.decode_step(jp, jcfg, jcache, jnp.asarray(tok))
        tlog, tcache = decode(tp, tcache, tok)
        _close(tlog, jlog, f"decode {step} logits")
        for k in jcache:
            _close(tcache[k], jcache[k], f"decode {step} cache {k}")
        tok = np.asarray(jlog.argmax(-1))[:, None].astype(np.int32)
    assert int(tcache["pos"]) == 524_288
