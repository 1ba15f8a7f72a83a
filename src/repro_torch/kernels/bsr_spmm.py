"""BSR x dense SpMM: the Hopper kernel's wrapper and its block-row offsets.

``bsr_spmm`` keeps the JAX package's signature and contract: blocks sorted
by block-row, ``b_n = min(b_n, N)`` and a ``ValueError`` unless ``N % b_n
== 0``.  It also raises on unsorted ``brows`` (where the TPU kernel silently
gives a wrong answer) and on indices out of range.  It computes the
block-row offsets on the host, once per call, and hands them to
``bsr_spmm_local``, which runs the plain version (``kernels.ref``) for CPU
tensors and launches the kernel of ``csrc/bsr_spmm.cu`` that ``route``
names for CUDA tensors, or raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels._build import DTYPE_CODE, as_index, check_inputs, load
from repro_torch.kernels.ref import bsr_spmm_ref


def row_offsets(brows, m_blocks: int) -> np.ndarray:
    """int32 ``row_start`` of a block list sorted by block-row: block-row r
    owns blocks ``row_start[r]:row_start[r + 1]`` (``m_blocks + 1``
    entries; an empty row has two equal offsets)."""
    rows = np.asarray(brows, dtype=np.int64).ravel()
    if len(rows) and (np.diff(rows) < 0).any():
        raise ValueError("brows must be sorted ascending (one program per block-row)")
    if len(rows) and (rows[0] < 0 or rows[-1] >= m_blocks):
        raise ValueError(f"brows must hold block-rows in [0, {m_blocks})")
    return np.searchsorted(rows, np.arange(m_blocks + 1)).astype(np.int32)


def bsr_spmm(
    blocks: torch.Tensor,  # (nb, bm, bk), sorted by brows
    brows,  # (nb,) int
    bcols,  # (nb,) int
    dense: torch.Tensor,  # (K, N)
    m_blocks: int,
    b_n: int = 128,
) -> torch.Tensor:
    """``A_bsr @ dense`` -> (m_blocks * bm, N) in ``promote_types(blocks,
    dense)``.  ``brows`` and ``bcols`` may be arrays, lists or tensors; they
    are checked on the host.  ``b_n`` is the TPU kernel's column tile; the
    port keeps its contract (``N`` must divide by ``min(b_n, N)``)."""
    if blocks.ndim != 3 or dense.ndim != 2:
        raise ValueError("blocks must be (nb, bm, bk) and dense (K, N)")
    nb, _, bk = blocks.shape
    K, N = dense.shape
    b_n = min(b_n, N)
    if N % b_n:
        raise ValueError(f"N={N} not divisible by b_n={b_n}")
    if K % bk:
        raise ValueError(f"K={K} not divisible by the block width {bk}")
    brows, bcols = (
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in (brows, bcols)
    )
    if len(brows) != nb or len(bcols) != nb:
        raise ValueError(f"brows and bcols must hold one entry per block ({nb})")
    if nb and not 0 <= bcols.min() <= bcols.max() < K // bk:
        raise ValueError(f"bcols must hold block-columns in [0, {K // bk})")
    row_start = row_offsets(brows, m_blocks)
    dev = blocks.device
    return bsr_spmm_local(
        blocks, as_index(row_start, dev), as_index(bcols, dev), dense, m_blocks
    )


# the __global__s of csrc/bsr_spmm.cu, numbered as its C entry point
# repro_bsr_spmm(kernel, blocks, row_start, bcols, dense, out, m_blocks, bm,
# bk, N, dtype code, stream) takes them
KERNELS = ("warp_rows", "mma_rows", "warp_blocks", "mma_blocks")

# the types mma_rows and mma_blocks multiply on the tensor cores; their
# products are exact in the fp32 accumulators, as in the reference's fp32 sum
TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)


@functools.cache
def _kernel():
    """The kernels' C entry point, built and bound on first use."""
    fn = load("bsr_spmm").repro_bsr_spmm
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def route(bm: int, bk: int, dtype: torch.dtype) -> str:
    """The kernel ``bsr_spmm_local`` launches for (bm, bk) blocks whose
    product is in ``dtype`` (the promoted type of blocks and dense), decided
    before the launch.

    A warp walks 128 columns of a run of block-rows 8 block columns (a k8
    unit) at a time, the next three steps' dense slabs in flight in its own
    ring in shared memory; bf16 and fp16 go on the tensor cores (the
    transposed product, two units a k16 mma step), fp32 on FMAs.  With
    bm = 8 and bk a multiple of 8: ``"mma_rows"`` (16-bit) and
    ``"warp_rows"`` (fp32).  Every other block shape (bm other than 8, or
    bk off a multiple of 8): ``"mma_blocks"`` and ``"warp_blocks"``, whose
    warps own up to 16 rows of a block-row (taller blocks in groups of 16)
    and zero-fill the k8 unit past bk."""
    tensor_cores = dtype in TENSOR_CORE_DTYPES
    if bm != 8 or bk % 8:
        return "mma_blocks" if tensor_cores else "warp_blocks"
    return "mma_rows" if tensor_cores else "warp_rows"


def bsr_spmm_local(
    blocks: torch.Tensor,
    row_start: torch.Tensor,
    bcols: torch.Tensor,
    dense: torch.Tensor,
    m_blocks: int,
) -> torch.Tensor:
    """``A_bsr @ dense`` from block-row offsets: all tensors on one device,
    ``row_start = row_offsets(brows, m_blocks)`` and every index in range
    (``bsr_spmm`` checks that).  On the CPU this is the plain version; on
    CUDA it launches the kernel ``route(bm, bk, result type)`` names (adding
    one to ``bsr_spmm_local.launches[kernel]``) or raises.  The result is
    in ``promote_types(blocks, dense)``, summed in fp32 over each block-row
    and rounded once; rows of empty block-rows are zero.

    Each block reads its own bk x N slab of ``dense``, so the kernels move
    several times the bytes of their inputs from L2 (at the AMG n=42 SpMM,
    N = 256: 0.70 GB in bf16, 1.39 GB in fp32, against 0.10 and 0.20 GB read
    once); every route is paced by that gather, which it keeps in flight."""
    device = blocks.device
    for name, t in (("row_start", row_start), ("bcols", bcols), ("dense", dense)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, blocks on {device}")
    if row_start.numel() != m_blocks + 1:
        raise ValueError("row_start must hold m_blocks + 1 offsets")
    _, bm, bk = blocks.shape
    N = dense.shape[1]
    if device.type == "cpu":
        brows = torch.repeat_interleave(
            torch.arange(m_blocks), torch.diff(row_start.long())
        )
        return bsr_spmm_ref(blocks, brows, bcols, dense, m_blocks)
    if device.type != "cuda":
        raise ValueError(f"no BSR SpMM kernel for device type {device.type!r}")
    check_inputs(
        [("blocks", blocks), ("dense", dense)],
        [("row_start", row_start), ("bcols", bcols)],
    )
    out_dtype = torch.promote_types(blocks.dtype, dense.dtype)
    # the kernel reads one element type: mixed inputs meet at the result type
    blocks = blocks.to(out_dtype)
    dense = dense.to(out_dtype)
    out = torch.empty((m_blocks * bm, N), dtype=out_dtype, device=device)
    if out.numel() == 0:
        return out
    kernel = route(bm, bk, out_dtype)
    with torch.cuda.device(device):
        err = _kernel()(
            KERNELS.index(kernel),
            blocks.data_ptr(),
            row_start.data_ptr(),
            bcols.data_ptr(),
            dense.data_ptr(),
            out.data_ptr(),
            m_blocks,
            bm,
            bk,
            N,
            DTYPE_CODE[out_dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bsr_spmm kernel {kernel} launch failed: CUDA error {err}")
    bsr_spmm_local.launches[kernel] += 1
    return out


# launches since the last reset, per __global__ of csrc/bsr_spmm.cu
bsr_spmm_local.launches = {name: 0 for name in KERNELS}
