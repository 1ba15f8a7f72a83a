"""The port's training path against the JAX package's on the CPU: for each
of the ten architectures at smoke size (attention, Mamba and hybrid
layers), in fp32, with JAX's
``init_params(cfg, jax.random.key(0))`` carried across by
``params_from_reference``, ``train_loss`` and every gradient leaf against
``jax.value_and_grad`` of ``repro.models.train_loss`` within 1e-4 (the
forward's tolerance, ``test_torch_lm.py``).  The MoE layers' expert
products and their gradients run K3's plain version here
(``GroupedGemm`` on CPU tensors), the SSM's scan its own reverse
recurrence (``layers.LinearScan``).  Activation checkpointing
(``remat_policy`` "nothing", "dots", "none") changes no gradient bit, and
"nothing" and "dots" really recompute.  One ``make_train_step`` step of
each optimizer is held to the reference's in ``test_torch_train_step.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as jax_configs
import repro.models.transformer as jax_tf
import repro_torch.configs as configs
import repro_torch.kernels.moe_gemm as k3
import repro_torch.models.transformer as tf
from repro_torch.models.convert import params_from_reference

TOL = 1e-4
ARCHS = configs.all_arch_ids()


def flat(tree, prefix=""):
    """{"a/b": leaf} of a nested dict tree (either package's)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got.detach().cpu(), np.float32),
                               np.asarray(want, np.float32), rtol=TOL, atol=TOL, err_msg=what)


def params(arch):
    jcfg = jax_configs.get_smoke_config(arch)
    jp = jax_tf.init_params(jcfg, jax.random.key(0))
    return jcfg, jp, params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")


def train_batch(cfg, B=2, S=64, seed=0):
    """``tests/test_arch_smoke.py``'s batch, as numpy: the same for both."""
    rng = np.random.default_rng(seed)
    n_front = 16 if cfg.frontend == "vision" else 0
    batch = {}
    if n_front:
        batch["frontend_embeds"] = rng.standard_normal((B, n_front, cfg.d_model)).astype(np.float32)
    batch["tokens"] = rng.integers(0, cfg.vocab, (B, S - n_front)).astype(np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab, (B, S - n_front)).astype(np.int32)
    return batch


def tree_of(leaves: dict) -> dict:
    """The nested tree of ``flat``'s {"a/b": leaf}."""
    tree = {}
    for k, v in leaves.items():
        node = tree
        *path, last = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def port_loss_and_grads(tp, cfg, batch, **kw):
    leaves = {k: v.detach().requires_grad_() for k, v in flat(tp).items()}
    loss, metrics = tf.train_loss(tree_of(leaves), cfg, batch, **kw)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss, metrics, {k: (torch.zeros_like(v) if g is None else g)
                           for (k, v), g in zip(leaves.items(), grads)}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_equal_jax(arch):
    jcfg, jp, tp = params(arch)
    tcfg = configs.get_smoke_config(arch)
    batch = train_batch(tcfg)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jax_tf.train_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True,
    )(jp)
    loss, metrics, grads = port_loss_and_grads(tp, tcfg, batch)
    assert loss.dtype == torch.float32 and sorted(metrics) == ["aux", "nll"]
    close(loss, jloss, "loss")
    for k in ("nll", "aux"):
        close(metrics[k], jmetrics[k], k)
    jflat = flat(jgrads)
    assert sorted(grads) == sorted(jflat)
    for k, g in grads.items():
        assert g.shape == jflat[k].shape and g.dtype == getattr(torch, str(jflat[k].dtype)), k
        close(g, jflat[k], f"grad {k}")
    assert float(sum(g.square().sum() for g in grads.values())) > 0


def test_masked_labels_and_frontend_positions_equal_jax():
    """Labels < 0 are masked and the loss reads the last S_lab positions
    (a vision frontend's 16 come first)."""
    arch = "llava-next-34b"
    jcfg, jp, tp = params(arch)
    tcfg = configs.get_smoke_config(arch)
    batch = train_batch(tcfg, seed=3)
    batch["labels"][:, ::3] = -1
    jloss, _ = jax_tf.train_loss(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, _ = port_loss_and_grads(tp, tcfg, batch)
    close(loss, jloss, "masked loss")


class _CountMm(TorchDispatchMode):
    """Counts plain matrix products (``aten.mm``) run under it."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "internlm2-1.8b", "falcon-mamba-7b",
                                  "hymba-1.5b"])
def test_remat_policies_give_equal_gradients(arch, monkeypatch):
    """"nothing", "dots" and "none" (and ``remat=False``) give the same
    loss and gradients bit for bit.  "nothing" recomputes every layer in
    the backward (K3's three forward products again a MoE layer, and the
    plain products); "dots" keeps the plain products' outputs, so its
    backward recomputes none of them; "none" recomputes nothing."""
    _, _, tp = params(arch)
    base = configs.get_smoke_config(arch)
    batch = train_batch(base)
    calls = {"n": 0}
    real = k3.moe_gemm

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(k3, "moe_gemm", counted)
    results = {}
    for policy, remat in (("none", False), ("nothing", True), ("dots", True), ("none", True)):
        cfg = dataclasses.replace(base, remat_policy=policy)
        calls["n"] = 0
        leaves = {k: v.detach().requires_grad_() for k, v in flat(tp).items()}
        loss, _ = tf.train_loss(tree_of(leaves), cfg, batch, remat=remat)
        forward_calls = calls["n"]
        with _CountMm() as mode:
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        results[(policy, remat)] = (loss, grads, forward_calls, calls["n"] - forward_calls,
                                    mode.mm)
    want_loss, want_grads, fwd, _, _ = results[("none", False)]
    for key, (loss, grads, f, b, mm) in results.items():
        assert torch.equal(loss, want_loss), key
        for g, w in zip(grads, want_grads):
            assert (g is None and w is None) or torch.equal(g, w), key
        assert f == fwd  # the forward makes the same K3 calls under every policy
    n_moe = 3 * base.n_layers if base.moe else 0
    assert fwd == n_moe
    assert results[("nothing", True)][3] == n_moe  # recomputed in the backward
    assert results[("dots", True)][3] == n_moe  # K3's products are batched: recomputed
    assert results[("none", True)][3] == results[("none", False)][3] == 0
    # the backward's plain products: "nothing" recomputes the forward's
    # again; "dots" saved them, so its backward runs only the gradients'
    mm = {key: r[4] for key, r in results.items()}
    assert mm[("none", True)] == mm[("none", False)] == mm[("dots", True)] < mm[("nothing", True)]


def test_forward_under_no_grad_equals_the_checkpointed_forward():
    """Under ``no_grad`` ``forward`` runs the plain layer loop whatever the
    policy (the serve steps), with the logits of the checkpointed one."""
    _, _, tp = params("internlm2-1.8b")
    cfg = configs.get_smoke_config("internlm2-1.8b")
    batch = train_batch(cfg)
    with torch.no_grad():
        plain, _ = tf.forward(tp, cfg, batch)
    remat, _ = tf.forward(tp, cfg, batch, remat=True)
    assert torch.equal(plain, remat.detach())


def test_unknown_remat_policy_raises():
    _, _, tp = params("internlm2-1.8b")
    cfg = dataclasses.replace(configs.get_smoke_config("internlm2-1.8b"), remat_policy="full")
    with pytest.raises(ValueError, match="remat_policy"):
        tf.train_loss(tp, cfg, train_batch(cfg))


def test_layer_slices_backward_stacks_once():
    """``layer_slices`` views the stacked leaves (no copy), and the gradient
    of a stacked leaf through them is one stack of the layers' gradients:
    one ``aten.stack`` a leaf, no ``select_backward`` zero-fills."""
    _, _, tp = params("internlm2-1.8b")
    cfg = configs.get_smoke_config("internlm2-1.8b")
    slices = tf.layer_slices(tp)
    assert len(slices) == cfg.n_layers
    wq = tp["layers"]["attn"]["wq"]
    assert slices[1]["attn"]["wq"].data_ptr() == wq[1].data_ptr()
    leaf = wq.detach().requires_grad_()
    parts = tf.layer_slices({"layers": {"w": leaf}})

    class Ops(TorchDispatchMode):
        seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func)
            return func(*args, **(kwargs or {}))

    loss = sum((p["w"] * (i + 1)).sum() for i, p in enumerate(parts))
    with Ops() as ops:
        (g,) = torch.autograd.grad(loss, [leaf])
    assert torch.ops.aten.stack.default in ops.seen
    assert torch.ops.aten.select_backward.default not in ops.seen
    for i in range(cfg.n_layers):
        assert torch.equal(g[i], torch.full_like(g[i], i + 1.0))
