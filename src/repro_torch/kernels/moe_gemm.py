"""Grouped expert GEMM: the Hopper kernels' wrapper.

``moe_gemm`` keeps the JAX package's signature and contract: the tiles
``(b_c, b_f, b_d)`` are clipped to the dims and must divide ``(C, f, d)``,
else ``ValueError``; the result is in ``x.dtype``, summed in fp32.  CPU
tensors run the plain version (``kernels.ref.moe_gemm_ref``); CUDA tensors
launch the kernels of ``csrc/moe_gemm.cu`` that ``launch_plan`` names (the
GEMM ``route`` picks, and the copies that give its operands the layout a
tensor map takes), or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import DTYPE_CODE, check_inputs, load
from repro_torch.kernels.ref import moe_gemm_ref, split3_bf16_ref, stage16_ref

# the types expert_wgmma multiplies on the tensor cores; their products are
# exact in its fp32 accumulators, as in the reference's fp32 dot
TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# the C entry point of each __global__ in csrc/moe_gemm.cu, and its arguments
_ENTRY = {
    # (x, w, out, E, C, d, f, x pitch, w pitch, out pitch, in dtype code,
    #  out dtype code, stream)
    "expert_wgmma": ("repro_moe_gemm_wgmma", [_PTR] * 3 + [_INT] * 9 + [_PTR]),
    # (x pieces, w pieces, out, E, C, d, f, x pitch, w pitch, out dtype code, stream)
    "expert_split": ("repro_moe_gemm_split", [_PTR] * 3 + [_INT] * 7 + [_PTR]),
    # (src, dst, rows, cols, pitch, stream)
    "split3_bf16": ("repro_split3_bf16", [_PTR, _PTR, ctypes.c_longlong, _INT, _INT, _PTR]),
    # (src, dst, rows, src pitch, dst pitch, stream)
    "stage16": ("repro_stage16", [_PTR, _PTR, ctypes.c_longlong, _INT, _INT, _PTR]),
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
    moe_gemm.launches[kernel] += 1


def _pitch(n: int) -> int:
    """``n`` values rounded up to a whole number of 16-byte bf16 chunks: the
    row pitch a tensor map can stride by."""
    return -(-n // 8) * 8


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The GEMM kernel ``moe_gemm`` launches for ``x`` (E, C, d) and ``w``
    (E, d, f) on the card, decided before the launch.

    ``"expert_wgmma"`` (bf16 or fp16 products on the tensor cores, operands
    by TMA) when x and w share bf16 or fp16; ``"expert_split"`` (the six
    fp32-accurate products of bf16 pieces on the tensor cores, after
    ``split3_bf16``) for fp32 and mixed inputs, which meet at fp32.  Any
    alignment, d and f: a tensor map needs a 16-byte-aligned base and a row
    pitch of a multiple of 8 values, so an operand off either is copied
    first into a fresh buffer that has them (``stage16`` for 16-bit inputs;
    ``split3_bf16`` writes its pieces so anyway), and the map keeps the true
    d and f (``launch_plan`` lists the copies).  A copy reads and writes
    each value once: for the Qwen3-MoE up projection with x 2 bytes off,
    1.34 GB, 0.40 ms at an H100's 3.35 TB/s, beside the GEMM's 1.04 ms
    bound."""
    if x.dtype == w.dtype and x.dtype in TENSOR_CORE_DTYPES:
        return "expert_wgmma"
    return "expert_split"


def _needs_stage(t: torch.Tensor) -> bool:
    """A 16-bit operand whose base or row pitch a tensor map cannot take."""
    return t.data_ptr() % 16 != 0 or t.shape[-1] % 8 != 0


def launch_plan(x: torch.Tensor, w: torch.Tensor) -> dict[str, int]:
    """The launches ``moe_gemm(x, w)`` makes on the card, by kernel: the
    GEMM ``route`` names, and its copies.  ``expert_split`` takes two
    ``split3_bf16`` passes (x and w); ``expert_wgmma`` takes one ``stage16``
    for each of x and w that ``_needs_stage``, and one more that copies the
    output's f columns out of a pitched buffer when f is off 8.  Empty
    results launch nothing."""
    E, C, _ = x.shape
    f = w.shape[-1]
    if E * C * f == 0:
        return {}
    kernel = route(x, w)
    if kernel == "expert_split":
        return {"split3_bf16": 2, kernel: 1}
    stages = _needs_stage(x) + _needs_stage(w) + (f % 8 != 0)
    return {"stage16": stages, kernel: 1} if stages else {kernel: 1}


def split3_bf16(x: torch.Tensor, pitch: int | None = None) -> torch.Tensor:
    """fp32 ``x`` as three bf16 pieces, (3, *x.shape[:-1], pitch),
    ``x == x0 + x1 + x2``, each row padded with zeros from ``x.shape[-1]``
    to ``pitch`` values (default: no padding).

    CPU tensors run the plain version (``ref.split3_bf16_ref``); CUDA
    tensors launch ``csrc/moe_gemm.cu``'s ``split3_bf16`` (adding one to
    ``moe_gemm.launches["split3_bf16"]``) or raise."""
    cols = x.shape[-1]
    pitch = cols if pitch is None else pitch
    if pitch < cols:
        raise ValueError(f"pitch {pitch} is narrower than the rows ({cols})")
    if x.device.type == "cpu":
        return split3_bf16_ref(x, pitch)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"split3_bf16 takes a contiguous float32 tensor, not {x.dtype}")
    pieces = torch.empty((3, *x.shape[:-1], pitch), dtype=torch.bfloat16, device=x.device)
    rows = x.numel() // cols if cols else 0
    _launch("split3_bf16", x.device, x.data_ptr(), pieces.data_ptr(), rows, cols, pitch)
    return pieces


def stage16(x: torch.Tensor, pitch: int) -> torch.Tensor:
    """A fresh contiguous (*x.shape[:-1], pitch) copy of the 16-bit ``x``:
    each row's first min(x.shape[-1], pitch) values, then zeros.  Pads rows
    to a pitch a tensor map can take, or crops a pitched result back to its
    width; the copy's base is 16-byte aligned wherever ``x`` starts.

    CPU tensors run the plain version (``ref.stage16_ref``); CUDA tensors
    launch ``csrc/moe_gemm.cu``'s ``stage16`` (adding one to
    ``moe_gemm.launches["stage16"]``) or raise."""
    if x.device.type == "cpu":
        return stage16_ref(x, pitch)
    if x.dtype not in TENSOR_CORE_DTYPES or not x.is_contiguous():
        raise ValueError(f"stage16 takes a contiguous 16-bit tensor, not {x.dtype}")
    out = torch.empty((*x.shape[:-1], pitch), dtype=x.dtype, device=x.device)
    cols = x.shape[-1]
    rows = x.numel() // cols if cols else 0
    _launch("stage16", x.device, x.data_ptr(), out.data_ptr(), rows, cols, pitch)
    return out


def moe_gemm(
    x: torch.Tensor,  # (E, C, d)
    w: torch.Tensor,  # (E, d, f)
    b_c: int = 128,
    b_f: int = 128,
    b_d: int = 512,
) -> torch.Tensor:
    """``out[e] = x[e] @ w[e]`` -> (E, C, f) in ``x.dtype``.

    The tiles are the TPU kernel's; the port checks their contract and
    tiles the card its own way.  On CUDA the GEMM is ``route(x, w)``,
    decided before the launch with the copies in front of it (no fallback
    from one kernel to another; ``launch_plan(x, w)`` lists them all); each
    launch adds one to ``moe_gemm.launches`` under its kernel's name."""
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
    if E * C * f == 0:
        return torch.empty((E, C, f), dtype=x.dtype, device=device)
    kernel = route(x, w)
    if kernel == "expert_split":
        out = torch.empty((E, C, f), dtype=x.dtype, device=device)
        # mixed inputs meet at fp32; the pieces' rows are padded to pitches
        # a tensor map takes, and expert_split writes x's type
        xp, wp = _pitch(d), _pitch(f)
        x_pieces = split3_bf16(x.float(), xp)
        w_pieces = split3_bf16(w.float(), wp)
        args = (x_pieces.data_ptr(), w_pieces.data_ptr(), out.data_ptr(), E, C, d, f, xp, wp)
        _launch(kernel, device, *args, DTYPE_CODE[out.dtype])
        return out
    if _needs_stage(x):
        x = stage16(x, _pitch(d))
    if _needs_stage(w):
        w = stage16(w, _pitch(f))
    # with f off 8 the output's rows are written at a pitch the map takes,
    # then copied out to their f columns
    out = torch.empty((E, C, _pitch(f)), dtype=x.dtype, device=device)
    code = DTYPE_CODE[x.dtype]
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f)
    _launch(kernel, device, *args, x.shape[-1], w.shape[-1], out.shape[-1], code, code)
    return out if f % 8 == 0 else stage16(out, f)


# launches since the last reset, per __global__ of csrc/moe_gemm.cu
moe_gemm.launches = {name: 0 for name in _ENTRY}
