"""The port's LM serving path against the JAX package's on the CPU: for each
attention-family architecture at smoke size, in fp32, with JAX's
``init_params(cfg, jax.random.key(0))`` carried across by
``params_from_reference``, ``forward``'s logits and aux loss,
``prefill_step``'s logits and KV cache, and three greedy ``decode_step``s,
within 1e-4.  The MoE layers' expert products run K3's plain version here
(``kernels.moe_gemm`` on CPU tensors).  The layers and the MoE cases are
held to JAX in ``test_torch_lm_layers.py``; the parameter trees, counts,
specs and token pipeline in ``test_torch_lm_shapes.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro.models.transformer as jax_tf
import repro_torch.configs as configs
import repro_torch.models.transformer as tf
from repro_torch.models.convert import params_from_reference
from repro_torch.training import make_decode_step, make_prefill_step

TOL = 1e-4
ATTN_ARCHS = [a for a in configs.all_arch_ids()
              if configs.get_smoke_config(a).layer_kind == "attn"]
SSM_ARCHS = [a for a in configs.all_arch_ids() if a not in ATTN_ARCHS]


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


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_forward_equals_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    batch = _batch(tcfg)
    jlog, jaux = jax_tf.forward(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    tlog, taux = tf.forward(tp, tcfg, batch)
    assert tlog.shape == jlog.shape and tlog.dtype == torch.float32
    _close(tlog, jlog, "logits")
    _close(taux, jaux, "aux")


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_prefill_and_decode_equal_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    cache = _serve_both(jcfg, tcfg, jp, tp, _batch(tcfg))
    assert int(cache["pos"]) == 64 + 3
