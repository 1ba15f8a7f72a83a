"""Grouped expert GEMM: the Hopper kernels' wrapper.

``moe_gemm`` keeps the JAX package's signature and contract: the tiles
``(b_c, b_f, b_d)`` are clipped to the dims and must divide ``(C, f, d)``,
else ``ValueError``; the result is in ``x.dtype``, summed in fp32.  CPU
tensors run the plain version (``kernels.ref.moe_gemm_ref``); CUDA tensors
launch the kernels of ``csrc/moe_gemm.cu`` that ``route`` names, or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import DTYPE_CODE, check_inputs, load
from repro_torch.kernels.ref import moe_gemm_ref, split3_bf16_ref

# the types expert_wgmma multiplies on the tensor cores; their products are
# exact in its fp32 accumulators, as in the reference's fp32 dot
TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# the C entry point of each __global__ in csrc/moe_gemm.cu, and its arguments
_ENTRY = {
    # (x, w, out, E, C, d, f, in dtype code, out dtype code, stream)
    "expert_tiles": ("repro_moe_gemm", [_PTR] * 3 + [_INT] * 6 + [_PTR]),
    "expert_wgmma": ("repro_moe_gemm_wgmma", [_PTR] * 3 + [_INT] * 6 + [_PTR]),
    # (x pieces, w pieces, out, E, C, d, f, out dtype code, stream)
    "expert_split": ("repro_moe_gemm_split", [_PTR] * 3 + [_INT] * 5 + [_PTR]),
    # (src, dst, n, stream)
    "split3_bf16": ("repro_split3_bf16", [_PTR, _PTR, ctypes.c_longlong, _PTR]),
}


@functools.cache
def _kernel(kernel: str):
    """The C entry point that launches ``kernel``, built and bound on first use."""
    name, argtypes = _ENTRY[kernel]
    fn = getattr(load("moe_gemm"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(kernel: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        err = _kernel(kernel)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_gemm kernel {kernel} launch failed: CUDA error {err}")


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel ``moe_gemm`` launches for ``x`` (E, C, d) and ``w`` (E, d, f)
    on the card.

    ``"expert_wgmma"`` (tensor cores, TMA) when x and w share bf16 or fp16,
    d and f are positive multiples of 8 and both data pointers are 16-byte
    aligned: a TMA tensor map's base address and strides are multiples of
    16 bytes.  ``"expert_split"`` (fp32-accurate products of bf16 pieces on
    the tensor cores, after ``split3_bf16``) for fp32 and mixed inputs,
    which meet at fp32, with d and f positive multiples of 8; their pieces
    are fresh aligned arrays, so the inputs' alignment does not matter.
    ``"expert_tiles"`` (fp32 FMAs on the CUDA cores) for everything else."""
    d, f = x.shape[-1], w.shape[-1]
    if d <= 0 or d % 8 or f % 8:
        return "expert_tiles"
    if x.dtype != w.dtype or x.dtype not in TENSOR_CORE_DTYPES:
        return "expert_split"
    if x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0:
        return "expert_wgmma"
    return "expert_tiles"


def split3_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` as three bf16 pieces, (3, *x.shape), ``x == x0 + x1 + x2``.

    CPU tensors run the plain version (``ref.split3_bf16_ref``); CUDA
    tensors launch ``csrc/moe_gemm.cu``'s ``split3_bf16`` (adding one to
    ``moe_gemm.launches["split3_bf16"]``) or raise."""
    if x.device.type == "cpu":
        return split3_bf16_ref(x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"split3_bf16 takes a contiguous float32 tensor, not {x.dtype}")
    pieces = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    _launch("split3_bf16", x.device, x.data_ptr(), pieces.data_ptr(), x.numel())
    moe_gemm.launches["split3_bf16"] += 1
    return pieces


def moe_gemm(
    x: torch.Tensor,  # (E, C, d)
    w: torch.Tensor,  # (E, d, f)
    b_c: int = 128,
    b_f: int = 128,
    b_d: int = 512,
) -> torch.Tensor:
    """``out[e] = x[e] @ w[e]`` -> (E, C, f) in ``x.dtype``.

    The tiles are the TPU kernel's; the port checks their contract and
    tiles the card its own way.  On CUDA the kernel is ``route(x, w)``,
    decided before the launch (no fallback from one kernel to another); each
    launch adds one to ``moe_gemm.launches`` under its kernel's name
    (``expert_split`` also launches ``split3_bf16`` once for x and once for w)."""
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(
            f"x must be (E, C, d) and w (E, d, f); got {tuple(x.shape)} and {tuple(w.shape)}"
        )
    E, C, d = x.shape
    f = w.shape[2]
    b_c, b_f, b_d = min(b_c, C), min(b_f, f), min(b_d, d)
    if C % b_c or f % b_f or d % b_d:
        raise ValueError(f"dims ({C},{f},{d}) not divisible by ({b_c},{b_f},{b_d})")
    device = x.device
    if w.device != device:
        raise ValueError(f"w is on {w.device}, x on {device}")
    if device.type == "cpu":
        return moe_gemm_ref(x, w)
    if device.type != "cuda":
        raise ValueError(f"no grouped GEMM kernel for device type {device.type!r}")
    check_inputs([("x", x), ("w", w)], [])
    out = torch.empty((E, C, f), dtype=x.dtype, device=device)
    kernel = route(x, w)
    # the kernels read one element type: mixed inputs meet at the promoted
    # type (float32), and they write x's type
    in_dtype = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(in_dtype), w.to(in_dtype)
    if out.numel() == 0:
        return out
    if kernel == "expert_split":
        x_pieces, w_pieces = split3_bf16(x), split3_bf16(w)
        args = (x_pieces.data_ptr(), w_pieces.data_ptr(), out.data_ptr(), E, C, d, f)
        _launch(kernel, device, *args, DTYPE_CODE[out.dtype])
    else:
        args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f)
        _launch(kernel, device, *args, DTYPE_CODE[in_dtype], DTYPE_CODE[out.dtype])
    moe_gemm.launches[kernel] += 1
    return out


# launches since the last reset, per __global__ of csrc/moe_gemm.cu
moe_gemm.launches = {name: 0 for name in _ENTRY}
