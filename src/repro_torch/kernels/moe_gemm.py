"""Grouped expert GEMM: the Hopper kernels' wrapper.

``moe_gemm`` keeps the JAX package's signature and contract: the tiles
``(b_c, b_f, b_d)`` are clipped to the dims and must divide ``(C, f, d)``,
else ``ValueError``; the result is in ``x.dtype``, summed in fp32.  CPU
tensors run the plain version (``kernels.ref.moe_gemm_ref``); CUDA tensors
launch the kernels of ``csrc/moe_gemm.cu`` that ``launch_plan`` names (the
GEMM ``route`` picks, and the copies that give its operands the layout a
tensor map takes), or raise ``KernelError``.

``GroupedGemm`` is ``moe_gemm`` with a gradient: its backward
(``moe_gemm_backward``) is two more grouped products on the card, ``dx =
dy @ wᵀ`` and ``dw = xᵀ @ dy``, launched on the operands as stored
(``grad_launch_plan(x, w, dy)`` lists them); on the CPU it runs the plain
version on the transposed operands.  The TPU kernel has no gradient (the
reference trains its MoE through ``jnp.einsum``), so this one is held to
``jax.grad`` of that einsum.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import DTYPE_CODE, KernelError, check_inputs, load
from repro_torch.kernels.ref import (
    moe_gemm_grad_ref,
    moe_gemm_ref,
    split3_bf16_ref,
    split3_bf16_t_ref,
    stage16_ref,
)

# the types expert_wgmma multiplies on the tensor cores; their products are
# exact in its fp32 accumulators, as in the reference's fp32 dot
TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# (a, dy, out, E, C, d, f, a pitch, dy pitch, out pitch, dtype code, stream):
# a is w for dx, x for dw
_GRAD = [_PTR] * 3 + [_INT] * 8 + [_PTR]
# the C entry point of each __global__ in csrc/moe_gemm.cu, and its arguments
_ENTRY = {
    # (A, B, out, E, m, k, n, A pitch, B pitch, out pitch, in dtype code,
    #  out dtype code, stream): x @ w
    "expert_wgmma": ("repro_moe_gemm_wgmma", [_PTR] * 3 + [_INT] * 9 + [_PTR]),
    "expert_wgmma_dx": ("repro_moe_gemm_dx", _GRAD),  # dy @ wᵀ, as (w @ dyᵀ)ᵀ
    "expert_wgmma_dw": ("repro_moe_gemm_dw", _GRAD),  # xᵀ @ dy
    # (x pieces, w pieces, out, E, C, d, f, x pitch, w pitch, out dtype code, stream)
    "expert_split": ("repro_moe_gemm_split", [_PTR] * 3 + [_INT] * 7 + [_PTR]),
    # (src, dst, rows, cols, pitch, stream)
    "split3_bf16": ("repro_split3_bf16", [_PTR, _PTR, ctypes.c_longlong, _INT, _INT, _PTR]),
    # (src, dst, batch, rows, cols, pitch, stream)
    "split3_bf16_t": ("repro_split3_bf16_t", [_PTR, _PTR] + [_INT] * 4 + [_PTR]),
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
        raise KernelError(f"moe_gemm kernel {kernel} launch failed: CUDA error {err}")
    _LAUNCHES[kernel] += 1


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


def _grad_route(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor) -> str:
    """``route`` for the backward: the 16-bit kernels when dy shares x's and
    w's 16-bit type, else the split products."""
    return "expert_wgmma" if route(x, w) == "expert_wgmma" and dy.dtype == x.dtype else (
        "expert_split")


def launch_plan(x: torch.Tensor, w: torch.Tensor) -> dict[str, int]:
    """The launches ``moe_gemm(x, w)`` makes on the card, by kernel: the
    GEMM ``route`` names, and its copies.  ``expert_split`` takes two
    ``split3_bf16`` passes (x and w); ``expert_wgmma`` takes one ``stage16``
    for each of x and w that ``_needs_stage``, and one more that copies the
    output's f columns out of a pitched buffer when f is off 8.  Empty
    results launch nothing."""
    E, C, d = x.shape
    f = w.shape[-1]
    if E * C * f == 0:
        return {}
    kernel = route(x, w)
    if kernel == "expert_split":
        return {"split3_bf16": 2, kernel: 1}
    stages = _needs_stage(x) + _needs_stage(w) + (f % 8 != 0)
    return {"stage16": stages, kernel: 1} if stages else {kernel: 1}


def grad_launch_plan(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor) -> dict[str, int]:
    """The launches ``moe_gemm_backward(x, w, dy)`` makes on the card, by
    kernel, for a contiguous ``dy`` (as it makes it): on the 16-bit route
    ``expert_wgmma_dx`` and ``expert_wgmma_dw`` and a ``stage16`` for each of
    dy, w and x that ``_needs_stage`` (dy once, for both) and for each
    output cropped from a pitched buffer (dx with d off 8, dw with f off 8);
    on the split route ``split3_bf16`` (dy, once for both), two
    ``split3_bf16_t`` (w for dx, x for dw) and two ``expert_split``.  Empty
    operands launch nothing."""
    E, C, d = x.shape
    f = w.shape[-1]
    if min(E, C, d, f) == 0:
        return {}
    if _grad_route(x, w, dy) == "expert_split":
        return {"split3_bf16": 1, "split3_bf16_t": 2, "expert_split": 2}
    stages = (_needs_stage(dy) + _needs_stage(w) + _needs_stage(x) + (d % 8 != 0)
              + (f % 8 != 0))
    plan = {"expert_wgmma_dx": 1, "expert_wgmma_dw": 1}
    return {"stage16": stages, **plan} if stages else plan


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
        raise KernelError(f"split3_bf16 takes a contiguous float32 tensor, not {x.dtype}")
    pieces = torch.empty((3, *x.shape[:-1], pitch), dtype=torch.bfloat16, device=x.device)
    rows = x.numel() // cols if cols else 0
    _launch("split3_bf16", x.device, x.data_ptr(), pieces.data_ptr(), rows, cols, pitch)
    return pieces


def split3_bf16_t(x: torch.Tensor, pitch: int) -> torch.Tensor:
    """fp32 ``x`` (..., rows, cols) as the three bf16 pieces of its
    transpose, (3, ..., cols, pitch): ``split3_bf16`` of
    ``x.transpose(-1, -2)`` with rows padded with zeros to ``pitch``, in one
    pass.

    CPU tensors run the plain version (``ref.split3_bf16_t_ref``); CUDA
    tensors launch ``csrc/moe_gemm.cu``'s ``split3_bf16_t`` (adding one to
    ``moe_gemm.launches["split3_bf16_t"]``) or raise."""
    rows, cols = x.shape[-2:]
    if pitch < rows:
        raise ValueError(f"pitch {pitch} is narrower than the transposed rows ({rows})")
    if x.device.type == "cpu":
        return split3_bf16_t_ref(x, pitch)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise KernelError(f"split3_bf16_t takes a contiguous float32 tensor, not {x.dtype}")
    lead = x.shape[:-2]
    pieces = torch.empty((3, *lead, cols, pitch), dtype=torch.bfloat16, device=x.device)
    batch = x.numel() // (rows * cols) if rows * cols else 0
    _launch("split3_bf16_t", x.device, x.data_ptr(), pieces.data_ptr(), batch, rows, cols, pitch)
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
        raise KernelError(f"stage16 takes a contiguous 16-bit tensor, not {x.dtype}")
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
    return _wgmma(x, w, C, d, f)


def _wgmma(x: torch.Tensor, w: torch.Tensor, C: int, d: int, f: int) -> torch.Tensor:
    """One ``expert_wgmma`` launch on aligned, pitched 16-bit operands; the
    (E, C, f) result, cropped from a pitched buffer by ``stage16`` where f
    is off 8."""
    out = torch.empty((x.shape[0], C, _pitch(f)), dtype=x.dtype, device=x.device)
    code = DTYPE_CODE[x.dtype]
    _launch("expert_wgmma", x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], C,
            d, f, x.shape[-1], w.shape[-1], out.shape[-1], code, code)
    return out if f % 8 == 0 else stage16(out, f)


def _grad(kernel: str, a: torch.Tensor, dy: torch.Tensor, C: int, d: int, f: int) -> torch.Tensor:
    """One launch of ``expert_wgmma_dx`` (``a`` = w, (E, d, f)) or
    ``expert_wgmma_dw`` (``a`` = x, (E, C, d)) on aligned, pitched 16-bit
    operands and dy (E, C, f): dx (E, C, d) or dw (E, d, f), cropped from a
    pitched buffer by ``stage16`` where its rows are off 8."""
    rows, cols = (C, d) if kernel == "expert_wgmma_dx" else (d, f)
    out = torch.empty((dy.shape[0], rows, _pitch(cols)), dtype=dy.dtype, device=dy.device)
    _launch(kernel, dy.device, a.data_ptr(), dy.data_ptr(), out.data_ptr(), dy.shape[0], C, d, f,
            a.shape[-1], dy.shape[-1], out.shape[-1], DTYPE_CODE[dy.dtype])
    return out if cols % 8 == 0 else stage16(out, cols)


def moe_gemm_backward(
    x: torch.Tensor,  # (E, C, d)
    w: torch.Tensor,  # (E, d, f)
    dy: torch.Tensor,  # (E, C, f), the gradient of moe_gemm(x, w)
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw) = (dy @ wᵀ, xᵀ @ dy)`` per expert, summed in fp32, dx in
    ``x.dtype`` and dw in ``w.dtype``.

    CPU tensors run the plain version (``ref.moe_gemm_grad_ref``).  On the
    card a non-contiguous ``dy`` is first copied contiguous (counted in
    ``GroupedGemm.dy_copies``), then the launches
    ``grad_launch_plan(x, w, dy)`` names run: 16-bit x, w and dy of one
    type take ``expert_wgmma_dx`` and ``expert_wgmma_dw``, reading w, x and
    dy as stored; anything else meets at fp32 and takes the split products,
    the operand read transposed split transposed by ``split3_bf16_t``.  A
    failed launch raises ``KernelError``."""
    E, C, d = x.shape
    f = w.shape[-1]
    if dy.shape != (E, C, f):
        raise ValueError(f"dy is {tuple(dy.shape)}, not {(E, C, f)}")
    device = x.device
    if device.type == "cpu":
        return moe_gemm_grad_ref(x, w, dy)
    if w.device != device or dy.device != device:
        raise ValueError(f"x is on {device}, w on {w.device}, dy on {dy.device}")
    if not dy.is_contiguous():
        dy = dy.contiguous()
        GroupedGemm.dy_copies += 1
    check_inputs([("x", x), ("w", w), ("dy", dy)], [])
    if min(E, C, d, f) == 0:
        return (torch.zeros((E, C, d), dtype=x.dtype, device=device),
                torch.zeros((E, d, f), dtype=w.dtype, device=device))
    if _grad_route(x, w, dy) == "expert_split":
        pd, pf, pc = _pitch(d), _pitch(f), _pitch(C)
        dy_pieces = split3_bf16(dy.float(), pf)  # dx's A and dw's B
        wt_pieces = split3_bf16_t(w.float(), pd)  # dx's B: (E, f, d)
        xt_pieces = split3_bf16_t(x.float(), pc)  # dw's A: (E, d, C)
        dx = torch.empty((E, C, d), dtype=x.dtype, device=device)
        dw = torch.empty((E, d, f), dtype=w.dtype, device=device)
        _launch("expert_split", device, dy_pieces.data_ptr(), wt_pieces.data_ptr(),
                dx.data_ptr(), E, C, f, d, pf, pd, DTYPE_CODE[dx.dtype])
        _launch("expert_split", device, xt_pieces.data_ptr(), dy_pieces.data_ptr(),
                dw.data_ptr(), E, d, C, f, pc, pf, DTYPE_CODE[dw.dtype])
        return dx, dw
    if _needs_stage(dy):
        dy = stage16(dy, _pitch(f))
    if _needs_stage(w):
        w = stage16(w, _pitch(f))
    if _needs_stage(x):
        x = stage16(x, _pitch(d))
    return _grad("expert_wgmma_dx", w, dy, C, d, f), _grad("expert_wgmma_dw", x, dy, C, d, f)


class GroupedGemm(torch.autograd.Function):
    """``moe_gemm`` with a gradient: ``GroupedGemm.apply(x, w)`` launches
    what ``moe_gemm(x, w)`` launches (under ``torch.no_grad`` too, so
    serving is unchanged), and its backward is ``moe_gemm_backward``: two
    more grouped products on the card, or their plain version on the CPU.
    Tiles as ``moe_gemm``'s (``apply(x, w, b_c, b_f, b_d)``)."""

    dy_copies = 0  # non-contiguous incoming gradients copied before a launch

    @staticmethod
    def forward(ctx, x, w, b_c=128, b_f=128, b_d=512):
        ctx.save_for_backward(x, w)
        return moe_gemm(x, w, b_c, b_f, b_d)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = moe_gemm_backward(x, w, dy)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None, None, None)


# launches since the last reset, per __global__ of csrc/moe_gemm.cu; one
# dict, whatever stands in for moe_gemm in a caller's hooks
_LAUNCHES = moe_gemm.launches = {name: 0 for name in _ENTRY}
