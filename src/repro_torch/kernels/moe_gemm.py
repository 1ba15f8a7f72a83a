"""Grouped expert GEMM: the Hopper kernels' wrapper.

``moe_gemm`` keeps the JAX package's signature and contract: the tiles
``(b_c, b_f, b_d)`` are clipped to the dims and must divide ``(C, f, d)``,
else ``ValueError``; the result is in ``x.dtype``, summed in fp32.  CPU
tensors run the plain version (``kernels.ref.moe_gemm_ref``); CUDA tensors
launch one of ``csrc/moe_gemm.cu``'s kernels, the one ``route`` names, or
raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import DTYPE_CODE, check_inputs, load
from repro_torch.kernels.ref import moe_gemm_ref

# the types expert_wgmma multiplies on the tensor cores; their products are
# exact in its fp32 accumulators, as in the reference's fp32 dot
TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)


# the C entry point of each __global__ in csrc/moe_gemm.cu; both take
# (x, w, out, E, C, d, f, in dtype code, out dtype code, stream)
_ENTRY = {"expert_tiles": "repro_moe_gemm", "expert_wgmma": "repro_moe_gemm_wgmma"}


@functools.cache
def _kernel(kernel: str):
    """The C entry point that launches ``kernel``, built and bound on first use."""
    fn = getattr(load("moe_gemm"), _ENTRY[kernel])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel ``moe_gemm`` launches for ``x`` (E, C, d) and ``w`` (E, d, f)
    on the card.

    ``"expert_wgmma"`` (tensor cores, TMA) when x and w share bf16 or fp16,
    d and f are positive multiples of 8 and both data pointers are 16-byte
    aligned: a TMA tensor map's base address and strides are multiples of
    16 bytes.  ``"expert_tiles"`` (fp32 FMAs on the CUDA cores) for
    everything else: fp32, mixed types (they meet at fp32), and shapes or
    views the tensor maps cannot describe."""
    d, f = x.shape[-1], w.shape[-1]
    if (
        x.dtype == w.dtype
        and x.dtype in TENSOR_CORE_DTYPES
        and d > 0
        and d % 8 == 0
        and f % 8 == 0
        and x.data_ptr() % 16 == 0
        and w.data_ptr() % 16 == 0
    ):
        return "expert_wgmma"
    return "expert_tiles"


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
    launch adds one to ``moe_gemm.launches[route(x, w)]``."""
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
    # the kernels read one element type: mixed inputs meet at the promoted
    # type (float32), and they write x's type
    in_dtype = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(in_dtype), w.to(in_dtype)
    if out.numel() == 0:
        return out
    kernel = route(x, w)
    with torch.cuda.device(device):
        err = _kernel(kernel)(
            x.data_ptr(),
            w.data_ptr(),
            out.data_ptr(),
            E,
            C,
            d,
            f,
            DTYPE_CODE[in_dtype],
            DTYPE_CODE[out.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"moe_gemm kernel {kernel} launch failed: CUDA error {err}")
    moe_gemm.launches[kernel] += 1
    return out


# launches since the last reset, per __global__ of csrc/moe_gemm.cu
moe_gemm.launches = {"expert_tiles": 0, "expert_wgmma": 0}
