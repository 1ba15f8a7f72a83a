"""Grouped expert GEMM: the Hopper kernel's wrapper.

``moe_gemm`` keeps the JAX package's signature and contract: the tiles
``(b_c, b_f, b_d)`` are clipped to the dims and must divide ``(C, f, d)``,
else ``ValueError``; the result is in ``x.dtype``, summed in fp32.  CPU
tensors run the plain version (``kernels.ref.moe_gemm_ref``); CUDA tensors
launch ``csrc/moe_gemm.cu`` or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import DTYPE_CODE, check_inputs, load
from repro_torch.kernels.ref import moe_gemm_ref


@functools.cache
def _kernel():
    """The kernel's C entry point, built and bound on first use."""
    fn = load("moe_gemm").repro_moe_gemm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def moe_gemm(
    x: torch.Tensor,  # (E, C, d)
    w: torch.Tensor,  # (E, d, f)
    b_c: int = 128,
    b_f: int = 128,
    b_d: int = 512,
) -> torch.Tensor:
    """``out[e] = x[e] @ w[e]`` -> (E, C, f) in ``x.dtype``.

    The tiles are the TPU kernel's; the port checks their contract and
    tiles the card its own way.  On CUDA this adds one to
    ``moe_gemm.launches["expert_tiles"]`` per launch."""
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
    # the kernel reads one element type: mixed inputs meet at the promoted
    # type (float32), and it writes x's type
    in_dtype = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(in_dtype), w.to(in_dtype)
    if out.numel() == 0:
        return out
    with torch.cuda.device(device):
        err = _kernel()(
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
        raise RuntimeError(f"moe_gemm kernel launch failed: CUDA error {err}")
    moe_gemm.launches["expert_tiles"] += 1
    return out


# launches since the last reset, per __global__ of csrc/moe_gemm.cu
moe_gemm.launches = {"expert_tiles": 0}
