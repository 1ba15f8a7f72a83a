"""The port's grouped expert GEMM (``repro_torch.kernels.ops.grouped_gemm``
and ``kernels.moe_gemm``) on the CPU, held against the JAX package's
``ops.grouped_gemm`` (its Pallas kernel in interpret mode) and its oracle."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.moe_gemm import moe_gemm as jax_moe_gemm
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gemm import moe_gemm, route


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# the shapes and tolerances of tests/test_kernels.py's moe_gemm test
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 32, 24), (4, 128, 64, 16)])
def test_grouped_gemm_matches_jax(dtype, shape):
    E, C, d, f = shape
    rng = np.random.default_rng(3)
    x = rng.standard_normal((E, C, d)).astype(dtype)
    w = rng.standard_normal((E, d, f)).astype(dtype)
    got = ops.grouped_gemm(x, w, device="cpu")
    assert got.shape == (E, C, f)
    assert got.dtype == (torch.float32 if dtype == np.float32 else torch.bfloat16)
    tol = 1e-5 if dtype == np.float32 else 5e-2
    for want in (
        jax_ops.grouped_gemm(x, w, interpret=True),
        jax_ops.moe_gemm_ref(jnp.asarray(x), jnp.asarray(w)),
    ):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "shape, tiles",
    [
        ((2, 48, 32, 16), {"b_c": 32}),  # C % b_c
        ((2, 16, 32, 48), {"b_f": 32}),  # f % b_f
        ((2, 16, 96, 16), {"b_d": 64}),  # d % b_d
        ((1, 200, 16, 16), {}),  # the default b_c = 128
    ],
)
def test_tiles_must_divide_in_both_packages(shape, tiles):
    E, C, d, f = shape
    x = np.ones((E, C, d), np.float32)
    w = np.ones((E, d, f), np.float32)
    with pytest.raises(ValueError, match="not divisible"):
        jax_moe_gemm(jnp.asarray(x), jnp.asarray(w), interpret=True, **tiles)
    with pytest.raises(ValueError, match="not divisible"):
        moe_gemm(torch.from_numpy(x), torch.from_numpy(w), **tiles)


def test_tiles_clip_to_small_dims_in_both_packages():
    """(b_c, b_f, b_d) = (128, 128, 512) clip to (C, f, d) = (24, 40, 56)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 24, 56)).astype(np.float32)
    w = rng.standard_normal((3, 56, 40)).astype(np.float32)
    got = ops.grouped_gemm(x, w, device="cpu")
    want = jax_ops.grouped_gemm(x, w, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "x_dtype, w_dtype", [(jnp.bfloat16, np.float32), (np.float32, jnp.bfloat16)]
)
def test_output_is_in_x_dtype_like_the_jax_kernel(x_dtype, w_dtype):
    """Both kernels write x's type; the JAX oracle's einsum promotes.  The
    port's plain version follows the kernels."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, 32)).astype(x_dtype)
    w = rng.standard_normal((2, 32, 24)).astype(w_dtype)
    got = ops.grouped_gemm(x, w, device="cpu")
    want_kernel = jax_ops.grouped_gemm(x, w, interpret=True)
    want_oracle = jax_ops.moe_gemm_ref(jnp.asarray(x), jnp.asarray(w))
    assert str(got.dtype).removeprefix("torch.") == str(want_kernel.dtype)
    assert str(want_kernel.dtype) == str(np.dtype(x_dtype))
    assert str(want_oracle.dtype) == "float32"
    plain = ops.moe_gemm_ref(ops.as_tensor(x, "cpu"), ops.as_tensor(w, "cpu"))
    assert plain.dtype == got.dtype
    tol = 1e-5 if x_dtype == np.float32 else 5e-2
    np.testing.assert_allclose(_f32(got), _f32(want_kernel), rtol=tol, atol=tol)


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="x must be"):
        moe_gemm(torch.ones(2, 8, 16), torch.ones(2, 8, 16))
    with pytest.raises(ValueError, match="x must be"):
        moe_gemm(torch.ones(2, 8, 16), torch.ones(3, 16, 8))


def test_grouped_gemm_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, w = np.ones((1, 8, 8), np.float32), np.ones((1, 8, 8), np.float32)
    before = dict(moe_gemm.launches)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.grouped_gemm(x, w)
    np.testing.assert_array_equal(ops.grouped_gemm(x, w, device="cpu"), 8)
    assert moe_gemm.launches == before  # the CPU path launches no kernel


def _misaligned(shape, dtype):
    """A contiguous view that starts one element into a flat buffer."""
    return torch.zeros(math.prod(shape) + 1, dtype=dtype)[1:].view(shape)


# (E, C) of Qwen3-MoE-235B-A22B's experts; meta tensors carry the shape,
# dtype and an aligned data pointer without the memory.
@pytest.mark.parametrize(
    "x_dtype, w_dtype, d, f, misaligned, kernel",
    [
        (torch.bfloat16, torch.bfloat16, 4096, 1536, False, "expert_wgmma"),
        (torch.float16, torch.float16, 4096, 1536, False, "expert_wgmma"),
        (torch.float32, torch.float32, 4096, 1536, False, "expert_split"),
        (torch.bfloat16, torch.float32, 4096, 1536, False, "expert_split"),
        (torch.float16, torch.bfloat16, 4096, 1536, False, "expert_split"),
        (torch.bfloat16, torch.bfloat16, 36, 1536, False, "expert_tiles"),  # d % 8
        (torch.bfloat16, torch.bfloat16, 4096, 20, False, "expert_tiles"),  # f % 8
        (torch.bfloat16, torch.bfloat16, 64, 48, True, "expert_tiles"),  # x 2 bytes off
        # fp32 and mixed inputs: split into fresh aligned pieces, so a view
        # off alignment takes the tensor cores too; d or f off 8 cannot
        (torch.float32, torch.float32, 64, 48, True, "expert_split"),  # x 4 bytes off
        (torch.float32, torch.bfloat16, 4096, 1536, False, "expert_split"),
        (torch.float32, torch.float32, 36, 1536, False, "expert_tiles"),  # d % 8
        (torch.float32, torch.float32, 4096, 20, False, "expert_tiles"),  # f % 8
        (torch.bfloat16, torch.float32, 4096, 12, False, "expert_tiles"),  # f % 8
    ],
)
def test_route_picks_the_kernel_before_launch(x_dtype, w_dtype, d, f, misaligned, kernel):
    if misaligned:
        x = _misaligned((2, 8, d), x_dtype)
        assert x.is_contiguous() and x.data_ptr() % 16 == x.element_size()
        w = torch.zeros((2, d, f), dtype=w_dtype)
    else:
        x = torch.empty((128, 640, d), dtype=x_dtype, device="meta")
        w = torch.empty((128, d, f), dtype=w_dtype, device="meta")
    assert route(x, w) == kernel
