"""K3's gradient on the CPU (``kernels.moe_gemm.GroupedGemm``, whose
backward ``moe_gemm_backward`` runs the plain version here): against
``torch.autograd`` through ``moe_gemm_ref`` and against ``jax.grad`` of the
reference's einsum (the reference trains its MoE through
``jnp.einsum("ecd,edf->ecf")``; the TPU kernel has no gradient), at C, d
and f off a multiple of 8 and at the MoE layer's own shapes, in fp32 and
bf16; ``grad_launch_plan``'s launches; the transposing split's plain
version; and the MoE layer taking the Function only where a gradient is
wanted.

Tolerances: fp32 within 1e-5 (both sum in fp32, in another order); bf16
against autograd through ``moe_gemm_ref`` within one bf16 ulp (each rounds
the same fp32 sum once), against JAX within the repo's bf16 rule (2e-2 +
2e-2 |want|: XLA's bf16 einsum rounds where it likes)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as configs
import repro_torch.kernels.moe_gemm as k3
from repro_torch.kernels.moe_gemm import GroupedGemm, grad_launch_plan, moe_gemm_backward
from repro_torch.kernels.ref import (
    moe_gemm_grad_ref,
    moe_gemm_ref,
    split3_bf16_ref,
    split3_bf16_t_ref,
)

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2.0**-7, atol=1e-6)}
JAX_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _qwen3_layer_shape():
    """(E, C, d, f) of the Qwen3-MoE smoke config's up projection at 2 x 64 tokens."""
    cfg = configs.get_smoke_config("qwen3-moe-235b-a22b")
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    cap = int(np.ceil(128 * K / E * cfg.moe.capacity_factor))
    return E, cap, cfg.d_model, cfg.moe.d_ff_expert


SHAPES = [(2, 16, 32, 24), (3, 13, 21, 11), (2, 9, 40, 17), (1, 1, 8, 8), _qwen3_layer_shape()]


def _operands(shape, dtype, seed=0):
    E, C, d, f = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
    g = rng.standard_normal((E, C, f)).astype(np.float32)
    return [torch.from_numpy(a).to(dtype) for a in (x, w, g)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_grouped_gemm_gradient_equals_autograd_through_the_plain_version(shape, dtype):
    x, w, g = _operands(shape, dtype)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = GroupedGemm.apply(xa, wa)
    assert torch.equal(out, moe_gemm_ref(x, w))
    out.backward(g)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    # autograd through the plain version's fp32 einsum, rounded once
    torch.einsum("ecd,edf->ecf", xb.float(), wb.float()).backward(g.float())
    assert xa.grad.dtype == dtype and wa.grad.dtype == dtype
    torch.testing.assert_close(xa.grad, xb.grad, **TOL[dtype])
    torch.testing.assert_close(wa.grad, wb.grad, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_grouped_gemm_gradient_equals_jax_grad_of_the_reference_einsum(shape, dtype):
    x, w, g = _operands(shape, dtype, seed=1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx, jw, jg = (jnp.asarray(t.float().numpy(), jdt) for t in (x, w, g))
    jdx, jdw = jax.grad(
        lambda a, b: jnp.sum(jnp.einsum("ecd,edf->ecf", a, b).astype(jnp.float32)
                             * jg.astype(jnp.float32)), argnums=(0, 1))(jx, jw)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    GroupedGemm.apply(xa, wa).backward(g)
    for got, want in ((xa.grad, jdx), (wa.grad, jdw)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   **JAX_TOL[dtype])


def test_mixed_types_give_each_input_its_own_type():
    """bf16 x and fp32 w: dx in bf16, dw in fp32, each rounded once from
    the fp32 sums (the card's split route writes each type directly)."""
    x, _, g = _operands((2, 10, 12, 6), torch.bfloat16)
    w = _operands((2, 10, 12, 6), torch.float32)[1]
    dx, dw = moe_gemm_backward(x, w, g)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    want_dx = torch.einsum("ecf,edf->ecd", g.float(), w).bfloat16()
    want_dw = torch.einsum("ecd,ecf->edf", x.float(), g.float())
    assert torch.equal(dx, want_dx)
    torch.testing.assert_close(dw, want_dw, rtol=1e-6, atol=1e-6)
    assert torch.equal(moe_gemm_grad_ref(x, w, g)[0], dx)


def test_backward_refuses_a_wrong_gradient_shape():
    x, w, g = _operands((2, 8, 16, 8), torch.float32)
    with pytest.raises(ValueError, match="dy is"):
        moe_gemm_backward(x, w, g[:, :4])


def test_only_the_wanted_gradients_are_returned():
    x, w, g = _operands((2, 8, 16, 8), torch.float32)
    wa = w.clone().requires_grad_()
    GroupedGemm.apply(x, wa).backward(g)
    assert wa.grad is not None and x.grad is None


@pytest.mark.parametrize(
    "shape, dtype, want",
    [
        ((4, 320, 4096, 1536), torch.bfloat16, {"expert_wgmma_dx": 1, "expert_wgmma_dw": 1}),
        ((4, 320, 4096, 1536), torch.float16, {"expert_wgmma_dx": 1, "expert_wgmma_dw": 1}),
        # d off 8: x staged and dx cropped; f off 8: dy and w staged, dw cropped
        ((2, 130, 1001, 256), torch.bfloat16,
         {"stage16": 2, "expert_wgmma_dx": 1, "expert_wgmma_dw": 1}),
        ((2, 130, 1000, 257), torch.bfloat16,
         {"stage16": 3, "expert_wgmma_dx": 1, "expert_wgmma_dw": 1}),
        ((2, 130, 1001, 257), torch.bfloat16,
         {"stage16": 5, "expert_wgmma_dx": 1, "expert_wgmma_dw": 1}),
        ((3, 200, 72, 136), torch.float32,
         {"split3_bf16": 1, "split3_bf16_t": 2, "expert_split": 2}),
        ((2, 0, 8, 8), torch.bfloat16, {}),
    ],
)
def test_launch_plan_lists_the_gradient_launches(shape, dtype, want):
    E, C, d, f = shape
    x = torch.empty((E, C, d), dtype=dtype)
    w = torch.empty((E, d, f), dtype=dtype)
    dy = torch.empty((E, C, f), dtype=dtype)
    assert grad_launch_plan(x, w, dy) == want


def test_launch_plan_takes_the_split_route_for_mixed_types():
    x = torch.empty((2, 16, 32), dtype=torch.bfloat16)
    w = torch.empty((2, 32, 24), dtype=torch.float32)
    dy = torch.empty((2, 16, 24), dtype=torch.bfloat16)
    assert grad_launch_plan(x, w, dy) == {"split3_bf16": 1, "split3_bf16_t": 2, "expert_split": 2}


@pytest.mark.parametrize("shape, pitch", [((2, 5, 7), 8), ((3, 16, 9), 16), ((4, 4), 6)])
def test_split3_bf16_t_plain_version_splits_the_transpose_exactly(shape, pitch):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)) * 1e3
    pieces = k3.split3_bf16_t(x, pitch)
    rows = shape[-2]
    assert pieces.shape == (3, *shape[:-2], shape[-1], pitch) and pieces.dtype == torch.bfloat16
    assert torch.equal(pieces.double().sum(0)[..., :rows], x.transpose(-1, -2).double())
    assert not pieces[..., rows:].any()
    assert torch.equal(split3_bf16_t_ref(x, pitch),
                       split3_bf16_ref(x.transpose(-1, -2).contiguous(), pitch))
    with pytest.raises(ValueError, match="narrower"):
        k3.split3_bf16_t(x, rows - 1)


def test_moe_layer_takes_the_function_only_when_a_gradient_is_wanted(monkeypatch):
    """``expert_gemm`` always goes through ``GroupedGemm``, one ``moe_gemm``
    call a product, under ``no_grad`` (the serve steps) too; the result
    records ``GroupedGemm``'s backward only when autograd records and an
    operand needs a gradient."""
    from repro_torch.models import layers

    calls = []
    real = k3.moe_gemm

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(k3, "moe_gemm", spy)
    x, w, _ = _operands((2, 8, 16, 8), torch.float32)
    with torch.no_grad():
        out = layers.expert_gemm(x, w.requires_grad_())
    assert out.grad_fn is None and len(calls) == 1
    out = layers.expert_gemm(x, w)
    assert type(out.grad_fn).__name__ == "GroupedGemmBackward" and len(calls) == 2
    out.sum().backward()  # the backward runs moe_gemm_backward, not moe_gemm
    assert len(calls) == 2 and w.grad is not None
    out = layers.expert_gemm(x, w.detach())
    assert out.grad_fn is None and len(calls) == 3
