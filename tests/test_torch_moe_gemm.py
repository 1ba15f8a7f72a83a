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
from repro_torch.kernels.moe_gemm import launch_plan, moe_gemm, route, split3_bf16, stage16
from repro_torch.kernels.ref import moe_gemm_ref, split3_bf16_ref, stage16_ref


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
        # 16-bit inputs a tensor map cannot take are copied first (stage16)
        (torch.bfloat16, torch.bfloat16, 36, 1536, False, "expert_wgmma"),  # d % 8
        (torch.bfloat16, torch.bfloat16, 4096, 20, False, "expert_wgmma"),  # f % 8
        (torch.bfloat16, torch.bfloat16, 64, 48, True, "expert_wgmma"),  # x 2 bytes off
        # fp32 and mixed inputs: split into fresh aligned pieces, rows padded
        # to a multiple of 8, so any alignment, d and f take the tensor cores
        (torch.float32, torch.float32, 64, 48, True, "expert_split"),  # x 4 bytes off
        (torch.float32, torch.bfloat16, 4096, 1536, False, "expert_split"),
        (torch.float32, torch.float32, 36, 1536, False, "expert_split"),  # d % 8
        (torch.float32, torch.float32, 4096, 20, False, "expert_split"),  # f % 8
        (torch.bfloat16, torch.float32, 4096, 12, False, "expert_split"),  # f % 8
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


# (d, f, x one value into its buffer, w one value in) -> the launches on the
# card: the GEMM and the copies that give its operands a tensor map's layout
@pytest.mark.parametrize(
    "dtype, d, f, x_off, w_off, plan",
    [
        (torch.bfloat16, 4096, 1536, False, False, {"expert_wgmma": 1}),
        (torch.bfloat16, 4096, 1536, True, False, {"stage16": 1, "expert_wgmma": 1}),
        (torch.float16, 4096, 1536, False, True, {"stage16": 1, "expert_wgmma": 1}),
        (torch.bfloat16, 36, 1536, False, False, {"stage16": 1, "expert_wgmma": 1}),  # x
        (torch.float16, 4096, 20, False, False, {"stage16": 2, "expert_wgmma": 1}),  # w, out
        (torch.bfloat16, 1001, 257, True, True, {"stage16": 3, "expert_wgmma": 1}),
        (torch.float32, 1001, 257, True, True, {"split3_bf16": 2, "expert_split": 1}),
    ],
)
def test_launch_plan_lists_the_stages(dtype, d, f, x_off, w_off, plan):
    x = _misaligned((2, 8, d), dtype) if x_off else torch.zeros((2, 8, d), dtype=dtype)
    w = _misaligned((2, d, f), dtype) if w_off else torch.zeros((2, d, f), dtype=dtype)
    assert launch_plan(x, w) == plan
    assert launch_plan(x[:, :0], w) == {}  # an empty result launches nothing


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("cols, pitch", [(36, 40), (20, 24), (257, 264), (40, 40), (264, 257)])
def test_stage16_plain_version_pads_and_crops_bit_for_bit(dtype, cols, pitch):
    """The stage's plain version: each row's first min(cols, pitch) values
    bit for bit, zeros at the edge, a fresh contiguous tensor (what the
    kernel writes, from any start, into an aligned buffer)."""
    rng = np.random.default_rng(cols + pitch)
    bits = rng.integers(0, 2**16, 3 * 5 * cols, dtype=np.uint16)
    x = _misaligned((3, 5, cols), torch.int16)
    x.copy_(torch.from_numpy(bits.view(np.int16)).view(3, 5, cols))
    x = x.view(dtype)  # any 16-bit pattern, NaNs too
    got = stage16(x, pitch)
    assert got.shape == (3, 5, pitch) and got.is_contiguous() and got.dtype == dtype
    want = np.zeros((3, 5, pitch), np.uint16)
    keep = min(cols, pitch)
    want[..., :keep] = bits.reshape(3, 5, cols)[..., :keep]
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    assert torch.equal(stage16_ref(x, pitch).view(torch.int16), got.view(torch.int16))


def test_split3_plain_version_pads_rows_with_zero_pieces():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((3, 5, 37)).astype(np.float32))
    got = split3_bf16(x, 40)
    assert got.shape == (3, 3, 5, 40)
    assert torch.equal(got[..., :37], split3_bf16_ref(x))
    assert not got[..., 37:].any()
    assert torch.equal(got.double().sum(0)[..., :37], x.double())


def _staged_plain(x, w):
    """The card's route for x (E, C, d) and w (E, d, f) in plain PyTorch,
    staged as the kernels stage it: rows padded with zeros to pitches of a
    multiple of 8 (what stage16 or split3_bf16 writes; past the true d and
    f, a tensor map reads zeros, so w's rows past d are zero too), the
    product on the padded operands, the output's f columns copied out.
    16-bit: products of the values in fp32; fp32 and mixed inputs: the six
    products of split3_bf16 pieces, i + j <= 2."""
    E, C, d = x.shape
    f = w.shape[2]
    d8, f8 = -(-d // 8) * 8, -(-f // 8) * 8
    pad_k = (0, 0, 0, d8 - d)  # w's k rows up to d8
    if route(x, w) == "expert_wgmma":
        xs = stage16_ref(x, d8)
        ws = torch.nn.functional.pad(stage16_ref(w, f8), pad_k)
        out = moe_gemm_ref(xs, ws)
    else:
        xs = split3_bf16_ref(x, d8).float()
        ws = torch.nn.functional.pad(split3_bf16_ref(w, f8).float(), pad_k)
        out = sum(torch.einsum("ecd,edf->ecf", xs[i], ws[j])
                  for i in range(3) for j in range(3 - i)).to(x.dtype)
    return stage16_ref(out, f) if out.dtype in (torch.bfloat16, torch.float16) else out[..., :f]


@pytest.mark.parametrize(
    "x_dtype, w_dtype",
    [(jnp.bfloat16, jnp.bfloat16), (np.float16, np.float16), (np.float32, np.float32),
     (jnp.bfloat16, np.float32)],
)
@pytest.mark.parametrize("shape, x_off", [((2, 16, 36, 24), False), ((2, 16, 32, 20), False),
                                          ((3, 8, 41, 13), False), ((2, 16, 32, 24), True)])
def test_staged_plain_path_matches_jax(shape, x_off, x_dtype, w_dtype):
    """d off 8, f off 8, both, and x a view one value into its buffer: the
    staged route's plain model against the JAX kernel in interpret mode.
    Tolerances: fp32 1e-5 (the split's terms left out are below 2^-24 of
    the sum), 16-bit 5e-2, as test_grouped_gemm_matches_jax."""
    E, C, d, f = shape
    rng = np.random.default_rng(d * f)
    x_np = rng.standard_normal((E, C, d)).astype(x_dtype)
    w_np = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(w_dtype)
    x, w = ops.as_tensor(x_np, "cpu"), ops.as_tensor(w_np, "cpu")
    if x_off:
        x = _misaligned((E, C, d), x.dtype).copy_(x)
        assert x.data_ptr() % 16 != 0
        assert launch_plan(x, w).get("stage16", 0) == (route(x, w) == "expert_wgmma")
    got = _staged_plain(x, w)
    assert got.shape == (E, C, f) and got.dtype == x.dtype
    tol = 1e-5 if x_dtype == np.float32 else 5e-2
    want = jax_ops.grouped_gemm(x_np, w_np, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    # and the port's plain version of the whole product
    np.testing.assert_allclose(_f32(got), _f32(moe_gemm(x, w)), rtol=tol, atol=tol)
