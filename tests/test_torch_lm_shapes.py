"""The port's LM stack's shapes against the JAX package's: the parameter
tree (keys, shapes, dtypes, scales) and the parameter counts of all ten
full configurations, the input and cache specs of every shape, the
synthetic token pipeline bit for bit; and the entry points need the card
unless told otherwise."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro.configs.shapes as jax_shapes
import repro.data.pipeline as jax_pipeline
import repro.models.transformer as jax_tf
import repro_torch.configs as configs
import repro_torch.configs.shapes as shapes
import repro_torch.data.pipeline as pipeline
import repro_torch.models.transformer as tf
from repro_torch.models.convert import params_from_reference


@pytest.mark.parametrize("arch", configs.all_arch_ids())
def test_param_counts_equal_jax(arch):
    jcfg, tcfg = jax_configs.get_config(arch), configs.get_config(arch)
    assert tf.param_count(tcfg) == jax_tf.param_count(jcfg)
    assert tf.active_param_count(tcfg) == jax_tf.active_param_count(jcfg)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# the leaves that are not drawn: norms' ones, biases' zeros, the SSM's constants
CONSTANTS = {"final_norm", "ln1", "ln2", "bq", "bk", "bv", "dt_proj", "a_log", "d_skip"}


@pytest.mark.parametrize("arch", configs.all_arch_ids())
def test_init_params_tree_equals_jax(arch):
    """Same keys, shapes and dtypes as the reference's tree (full size, on
    the meta device), and at smoke size the reference's scales."""
    jshapes = _flat(jax.eval_shape(lambda: jax_tf.init_params(jax_configs.get_config(arch),
                                                              jax.random.key(0))))
    tmeta = _flat(tf.init_params(configs.get_config(arch), device="meta"))
    assert sorted(jshapes) == sorted(tmeta)
    for k, s in jshapes.items():
        assert tuple(tmeta[k].shape) == s.shape and str(tmeta[k].dtype) == f"torch.{s.dtype}", k
    cfg = configs.get_smoke_config(arch)
    tp = _flat(tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    jp = _flat(jax_tf.init_params(jax_configs.get_smoke_config(arch), jax.random.key(0)))
    for k, j in jp.items():
        j = np.asarray(j, np.float64)
        t = tp[k].double().numpy()
        if k.split("/")[-1] in CONSTANTS:
            np.testing.assert_allclose(t, j, rtol=1e-6, err_msg=k)
        else:  # N(0, scale^2) draws: the same scale within sampling error
            assert abs(t.std() / j.std() - 1) < 0.15 and abs(t.mean()) < 0.2 * j.std(), k


@pytest.mark.parametrize("seed, step", [(0, 0), (0, 7), (3, 1)])
def test_synthetic_tokens_bit_for_bit(seed, step):
    for kw in (dict(vocab=256, seq_len=64, global_batch=4),
               dict(vocab=151936, seq_len=128, global_batch=6, n_hosts=2, host_id=1)):
        got = pipeline.SyntheticTokens(seed=seed, **kw).batch(step)
        want = jax_pipeline.SyntheticTokens(seed=seed, **kw).batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    cfg, spec = configs.get_smoke_config("qwen3-moe-235b-a22b"), shapes.ShapeSpec("t", "train", 32, 2)
    for k, v in jax_pipeline.make_batch(cfg, spec, step, seed).items():
        np.testing.assert_array_equal(pipeline.make_batch(cfg, spec, step, seed)[k], v)


@pytest.mark.parametrize("shape", sorted(shapes.SHAPES))
@pytest.mark.parametrize("arch", configs.all_arch_ids())
def test_input_and_cache_specs_equal_jax(arch, shape):
    jcfg, tcfg = jax_configs.get_config(arch), configs.get_config(arch)
    assert shapes.shape_applicable(tcfg, shape) == jax_shapes.shape_applicable(jcfg, shape)
    specs = [shapes.input_specs(tcfg, shape)]
    jspecs = [jax_shapes.input_specs(jcfg, shape)]
    if shapes.SHAPES[shape].kind == "decode":
        specs.append(shapes.cache_specs(tcfg, shape))
        jspecs.append(jax_shapes.cache_specs(jcfg, shape))
    for got, want in zip(specs, jspecs):
        assert sorted(got) == sorted(want)
        for k, s in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == s.shape and str(got[k].dtype) == f"torch.{s.dtype}", k


def test_entry_points_run_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke_config("internlm2-1.8b")
    for call in (lambda: tf.init_params(cfg), lambda: tf.init_kv_cache(cfg, 1, 8),
                 lambda: params_from_reference({"w": np.zeros(2, np.float32)})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    params = tf.init_params(cfg, 0, device="cpu")
    assert all(t.device.type == "cpu" for t in _flat(params).values())
