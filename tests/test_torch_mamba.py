"""The port's Mamba-1 selective SSM against the JAX package's on the CPU:
the causal convolution, the chunked scan ``mamba_scan`` (the reference's
chunk, several chunks, a chunk that does not divide S), its gradient
(``LinearScan``'s reverse recurrence) against ``jax.grad`` of the
reference's scan, torch autograd of a plain loop and a float64
``gradcheck``, ``mamba_block_with_state`` and ``mamba_decode_step`` in
fp32 within 1e-5 (``rtol`` and ``atol``), with JAX's
``init_params(cfg, jax.random.key(0))`` carried across by
``params_from_reference``; and ``mamba_block`` in bf16 within the repo's
bf16 rule of JAX's."""
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

TOL = 1e-5
BF16_TOL = 2e-2  # chip_smoke.py's bf16 rule: |got - want| <= 2e-2 + 2e-2 |want|
SSM_ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().cpu(), np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=what)


def scan_inputs(B=2, S=256, Di=24, N=16, seed=0):
    """Decays a = exp(dt A) of the model's range (A = -(1..N), as
    ``init_params``'s ``a_log`` gives; dt up to 1, so log a down to -16),
    bx from a seeded normal, a nonzero h0; float32 numpy."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.01, 1.0, (B, S, Di, 1))
    a = np.exp(dt * -np.arange(1, N + 1)).astype(np.float32)
    bx = rng.standard_normal((B, S, Di, N)).astype(np.float32)
    h0 = rng.standard_normal((B, Di, N)).astype(np.float32)
    return a, bx, h0


def loop64(a, bx, h0):
    """The recurrence in float64, one step at a time (numpy)."""
    h = h0.astype(np.float64)
    out = np.empty(a.shape, np.float64)
    for t in range(a.shape[1]):
        h = a[:, t] * h + bx[:, t]
        out[:, t] = h
    return out


def ssm_params(arch, dtype=None):
    """Layer 0's SSM parameters of ``arch``'s smoke config in both packages
    (JAX's init, carried across), and the config."""
    jcfg, tcfg = jax_configs.get_smoke_config(arch), configs.get_smoke_config(arch)
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
    jp = jax_tf.init_params(jcfg, jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return (jax.tree.map(lambda a: a[0], jp["layers"]["ssm"]),
            tf.layer_slices(tp)[0]["ssm"], tcfg)


def test_causal_conv_equals_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    want = jax_layers._causal_conv(jnp.asarray(x), jnp.asarray(w))
    got = layers._causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    _close(got, want)
    # causal: the first Kc - 1 outputs see only the sequence's start
    _close(got[:, 0], x[:, 0] * w[-1])


@pytest.mark.parametrize("chunk", [256, 8, 16, 64])
def test_mamba_scan_equals_jax(chunk):
    a, bx, h0 = scan_inputs()
    jall, jlast = jax_layers.mamba_scan(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0),
                                        chunk=chunk)
    tall, tlast = layers.mamba_scan(torch.from_numpy(a), torch.from_numpy(bx),
                                    torch.from_numpy(h0), chunk=chunk)
    assert tall.dtype == torch.float32 and tuple(tall.shape) == a.shape
    _close(tall, jall, "h_all")
    _close(tlast, jlast, "h_last")
    want = loop64(a, bx, h0)
    _close(tall, want, "h_all against float64")
    assert np.abs(want).max() > 1  # the states are not all small


def test_mamba_scan_refuses_a_chunk_that_does_not_divide_as_jax():
    a, bx, h0 = scan_inputs(S=100)
    with pytest.raises(ValueError, match="not divisible"):
        jax_layers.mamba_scan(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0), chunk=64)
    with pytest.raises(ValueError, match="not divisible"):
        layers.mamba_scan(torch.from_numpy(a), torch.from_numpy(bx), torch.from_numpy(h0),
                          chunk=64)
    # a chunk longer than S is clipped to S, in both
    layers.mamba_scan(torch.from_numpy(a), torch.from_numpy(bx), torch.from_numpy(h0))


def _scan_loss_weights(shape, seed=2):
    rng = np.random.default_rng(seed)
    B, S, Di, N = shape
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((B, Di, N)).astype(np.float32))


@pytest.mark.parametrize("chunk", [256, 16])
def test_scan_gradient_equals_jax_grad(chunk):
    """d/d(a, bx, h0) of a loss that reads every h_t and h_last."""
    a, bx, h0 = scan_inputs(S=128)
    w_all, w_last = _scan_loss_weights(a.shape)

    def jloss(a, bx, h0):
        h_all, h_last = jax_layers.mamba_scan(a, bx, h0, chunk=chunk)
        return (h_all * w_all).sum() + (h_last * w_last).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
    ts = [torch.from_numpy(v).requires_grad_() for v in (a, bx, h0)]
    h_all, h_last = layers.mamba_scan(*ts, chunk=chunk)
    loss = (h_all * torch.from_numpy(w_all)).sum() + (h_last * torch.from_numpy(w_last)).sum()
    got = torch.autograd.grad(loss, ts)
    for name, g, w in zip(("a", "bx", "h0"), got, want):
        _close(g, w, f"d{name}")
    assert float(got[0].abs().max()) > 1  # the gradients are not all small


def test_scan_gradient_equals_autograd_of_a_plain_loop():
    a, bx, h0 = scan_inputs(S=64)
    w_all, _ = _scan_loss_weights(a.shape)
    grads = []
    for scan in ("function", "loop"):
        ts = [torch.from_numpy(v).requires_grad_() for v in (a, bx, h0)]
        if scan == "function":  # time-major
            h_all = layers.LinearScan.apply(ts[0].transpose(0, 1), ts[1].transpose(0, 1),
                                            ts[2]).transpose(0, 1)
        else:
            h, steps = ts[2], []
            for t in range(a.shape[1]):
                h = ts[0][:, t] * h + ts[1][:, t]
                steps.append(h)
            h_all = torch.stack(steps, dim=1)
        grads.append(torch.autograd.grad((h_all * torch.from_numpy(w_all)).sum(), ts))
    for name, g, w in zip(("a", "bx", "h0"), *grads):
        _close(g, w, f"d{name}")


def test_scan_gradcheck_in_float64():
    """``LinearScan`` on time-major (S, B, Di, N) operands."""
    a, bx, h0 = scan_inputs(B=2, S=12, Di=3, N=4)
    ins = [torch.from_numpy(v).double().transpose(0, 1).contiguous().requires_grad_()
           for v in (a, bx)] + [torch.from_numpy(h0).double().requires_grad_()]
    assert torch.autograd.gradcheck(layers.LinearScan.apply, ins)


def test_scan_returns_only_the_wanted_gradients():
    a, bx, h0 = (torch.from_numpy(v) for v in scan_inputs(S=8))
    bx.requires_grad_()
    h = layers.LinearScan.apply(a.transpose(0, 1), bx.transpose(0, 1), h0)
    assert h.is_contiguous() and h.shape == (8, *h0.shape)
    (g,) = torch.autograd.grad(h.sum(), [bx])
    assert g.shape == bx.shape and a.grad is None and h0.grad is None


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_mamba_block_with_state_equals_jax(arch):
    jp, tp, cfg = ssm_params(arch)
    x = np.random.default_rng(4).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    want = jax_layers.mamba_block_with_state(jp, jnp.asarray(x), cfg, chunk=16)
    got = layers.mamba_block_with_state(tp, torch.from_numpy(x), cfg, chunk=16)
    Di, N = cfg.d_inner, cfg.ssm.d_state
    assert [tuple(g.shape) for g in got] == [(2, 64, cfg.d_model), (2, 3, Di), (2, Di, N)]
    for name, g, w in zip(("y", "conv_tail", "h_last"), got, want):
        _close(g, w, name)
    _close(layers.mamba_block(tp, torch.from_numpy(x), cfg), want[0], "mamba_block")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_mamba_decode_step_equals_jax(arch):
    jp, tp, cfg = ssm_params(arch)
    rng = np.random.default_rng(5)
    Di, N = cfg.d_inner, cfg.ssm.d_state
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, 3, Di)).astype(np.float32)
    h = rng.standard_normal((2, Di, N)).astype(np.float32)
    want = jax_layers.mamba_decode_step(jp, *(jnp.asarray(v) for v in (x, conv, h)), cfg)
    got = layers.mamba_decode_step(tp, *(torch.from_numpy(v) for v in (x, conv, h)), cfg)
    assert got[2].dtype == torch.float32
    for name, g, w in zip(("y", "conv", "h"), got, want):
        _close(g, w, name)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_mamba_block_in_bf16_within_the_bf16_rule_of_jax(arch):
    """bf16 weights and input; the scan in fp32 in both."""
    jp, tp, cfg = ssm_params(arch, dtype="bfloat16")
    assert tp["in_proj"].dtype == torch.bfloat16 and tp["a_log"].dtype == torch.bfloat16
    x = np.random.default_rng(6).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    want = jax_layers.mamba_block_with_state(jp, jnp.asarray(x, jnp.bfloat16), cfg)
    got = layers.mamba_block_with_state(tp, torch.from_numpy(x).bfloat16(), cfg)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    for name, g, w in zip(("y", "conv_tail", "h_last"), got, want):
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w)
        assert np.all(err <= BF16_TOL + BF16_TOL * np.abs(w)), (name, err.max())
