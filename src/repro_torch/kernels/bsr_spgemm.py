"""BSR x BSR SpGEMM: the Hopper kernel's wrapper, its inspector and its runs.

The paper's numeric SpGEMM on tiles: tiling A, B, C into b x b blocks is a
vertex coarsening of the fine-grained hypergraph (DESIGN.md Sec. 3).  The
host-side inspector (``build_pair_lists``, a copy of the JAX package's)
enumerates the coarse multiplication vertices — every (A-block, B-block)
pair with matching inner block index — sorted by their C block, and the
kernel (``csrc/bsr_spgemm.cu``) sums each run of pairs that share a C block.

``bsr_spgemm_local`` is the entry the executors call: its tensors are on one
device and its run offsets were computed once on the host (``pair_runs``).
On the CPU it runs the plain version (``kernels.ref.bsr_spgemm_ref``); on a
CUDA device it launches the kernel or raises.  ``bsr_spgemm`` keeps the JAX
package's signature and derives the runs from ``pair_c`` itself.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels.ref import bsr_spgemm_ref

MAX_BLOCK = 32  # one CUDA block of b*b threads per run
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def build_pair_lists(
    a_brows: np.ndarray,
    a_bcols: np.ndarray,
    b_brows: np.ndarray,
    b_bcols: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-side inspector: coarse multiplication vertices of the tiled
    SpGEMM.  Returns (pair_a, pair_b, pair_c, c_brows, c_bcols) with pair_c
    sorted and C blocks deduplicated.

    Vectorized (CSR-style index arithmetic: group B entries by block-row,
    expand each A entry by its match count, one lexsort); byte-identical to
    ``build_pair_lists_loop``, the original executable specification.
    """
    a_brows = np.asarray(a_brows, dtype=np.int64)
    a_bcols = np.asarray(a_bcols, dtype=np.int64)
    b_brows = np.asarray(b_brows, dtype=np.int64)
    b_bcols = np.asarray(b_bcols, dtype=np.int64)
    z = np.zeros(0, dtype=np.int64)
    if len(a_brows) == 0 or len(b_brows) == 0:
        return z, z, z, z, z
    K = int(max(a_bcols.max(), b_brows.max())) + 1
    # B entries grouped by inner block index k
    b_order = np.argsort(b_brows, kind="stable")
    b_cnt = np.bincount(b_brows, minlength=K)
    b_start = np.cumsum(b_cnt) - b_cnt
    # each A entry i matches the b_cnt[a_bcols[i]] B entries of its k-group
    rep = b_cnt[a_bcols]
    total = int(rep.sum())
    if total == 0:
        return z, z, z, z, z
    ai = np.repeat(np.arange(len(a_brows), dtype=np.int64), rep)
    off = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(rep) - rep, rep)
    bj = b_order[b_start[a_bcols[ai]] + off]
    r, c = a_brows[ai], b_bcols[bj]
    order = np.lexsort((bj, ai, c, r))  # the loop version's (r, c, i, j) sort
    pair_a, pair_b, r, c = ai[order], bj[order], r[order], c[order]
    GC = int(b_bcols.max()) + 1
    uniq, pair_c = np.unique(r * GC + c, return_inverse=True)
    return (
        pair_a,
        pair_b,
        pair_c.astype(np.int64),
        uniq // GC,
        uniq % GC,
    )


def build_pair_lists_loop(
    a_brows: np.ndarray,
    a_bcols: np.ndarray,
    b_brows: np.ndarray,
    b_bcols: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Original pure-Python inspector, kept as the executable specification
    of ``build_pair_lists`` (invariant-tested to match byte for byte)."""
    pairs = []
    by_k: dict[int, list[int]] = {}
    for j, k in enumerate(b_brows):
        by_k.setdefault(int(k), []).append(j)
    for i, (r, k) in enumerate(zip(a_brows, a_bcols)):
        for j in by_k.get(int(k), []):
            pairs.append((int(r), int(b_bcols[j]), i, j))
    if not pairs:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z, z
    pairs.sort()
    c_coords = sorted({(r, c) for r, c, _, _ in pairs})
    c_id = {rc: n for n, rc in enumerate(c_coords)}
    pair_a = np.array([p[2] for p in pairs], dtype=np.int64)
    pair_b = np.array([p[3] for p in pairs], dtype=np.int64)
    pair_c = np.array([c_id[(p[0], p[1])] for p in pairs], dtype=np.int64)
    c_brows = np.array([rc[0] for rc in c_coords], dtype=np.int64)
    c_bcols = np.array([rc[1] for rc in c_coords], dtype=np.int64)
    return pair_a, pair_b, pair_c, c_brows, c_bcols


def pair_runs(pair_c: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Group a pair list sorted by C block into runs, once, on the host.

    Returns int32 ``(run_start, run_c)``: run r covers pairs
    ``run_start[r]:run_start[r + 1]`` and accumulates into C block
    ``run_c[r]`` (``len(run_start) == n_runs + 1``).  One kernel program
    owns one run, so ``pair_c`` must be sorted: equal C blocks in two runs
    would race.
    """
    pc = np.asarray(pair_c, dtype=np.int64).ravel()
    if len(pc) and (np.diff(pc) < 0).any():
        raise ValueError("pair_c must be sorted ascending (one run per C block)")
    if len(pc) and (pc.min() < 0 or pc.max() > np.iinfo(np.int32).max):
        raise ValueError("pair_c holds indices outside [0, 2**31)")
    starts = np.flatnonzero(np.r_[True, pc[1:] != pc[:-1]]) if len(pc) else pc
    run_start = np.append(starts, len(pc)).astype(np.int32)
    return run_start, pc[starts].astype(np.int32)


def _as_index(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x, dtype=np.int32), device=device)


def bsr_spgemm(
    a_blocks: torch.Tensor,  # (na, bm, bk)
    b_blocks: torch.Tensor,  # (nb, bk, bn)
    pair_a,  # (np,) int, index into a_blocks
    pair_b,  # (np,) int
    pair_c,  # (np,) int sorted ascending (runs per C block)
    n_c_blocks: int,
) -> torch.Tensor:
    """The JAX package's ``bsr_spgemm`` signature: pair lists may be numpy
    arrays, lists or tensors.  They are bounds-checked and grouped into runs
    on the host, then moved to ``a_blocks``' device."""
    pair_a, pair_b, pair_c = (
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in (pair_a, pair_b, pair_c)
    )
    for name, idx, n in (
        ("pair_a", pair_a, a_blocks.shape[0]),
        ("pair_b", pair_b, b_blocks.shape[0]),
        ("pair_c", pair_c, n_c_blocks),
    ):
        if len(idx) != len(pair_c) or (len(idx) and not 0 <= idx.min() <= idx.max() < n):
            raise ValueError(f"{name} must hold len(pair_c) indices in [0, {n})")
    run_start, run_c = pair_runs(pair_c)
    dev = a_blocks.device
    return bsr_spgemm_local(
        a_blocks,
        b_blocks,
        _as_index(pair_a, dev),
        _as_index(pair_b, dev),
        _as_index(pair_c, dev),
        _as_index(run_start, dev),
        _as_index(run_c, dev),
        n_c_blocks,
    )


@functools.cache
def _kernel():
    """The kernel's C entry point, built and bound on first use."""
    from repro_torch.kernels import _build

    fn = _build.load("bsr_spgemm").repro_bsr_spgemm
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(a_blocks, b_blocks, index_tensors) -> int:
    """Validate what the CUDA kernel takes; returns the block size."""
    if a_blocks.ndim != 3 or b_blocks.ndim != 3:
        raise ValueError("a_blocks and b_blocks must be (n, b, b) block stacks")
    b = a_blocks.shape[1]
    if a_blocks.shape[1:] != (b, b) or b_blocks.shape[1:] != (b, b):
        raise ValueError(
            f"the CUDA kernel takes square blocks of one size; got "
            f"{tuple(a_blocks.shape[1:])} and {tuple(b_blocks.shape[1:])}"
        )
    if not 1 <= b <= MAX_BLOCK:
        raise ValueError(f"block size {b} outside [1, {MAX_BLOCK}]")
    for name, t in (("a_blocks", a_blocks), ("b_blocks", b_blocks)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} dtype {t.dtype} not in {tuple(_DTYPE_CODE)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in index_tensors:
        if t.dtype != torch.int32 or t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
    return b


def bsr_spgemm_local(
    a_blocks: torch.Tensor,
    b_blocks: torch.Tensor,
    pair_a: torch.Tensor,
    pair_b: torch.Tensor,
    pair_c: torch.Tensor,
    run_start: torch.Tensor,
    run_c: torch.Tensor,
    n_c_blocks: int,
) -> torch.Tensor:
    """``C[pair_c[i]] += A[pair_a[i]] @ B[pair_b[i]]`` -> (n_c_blocks, b, b).

    All tensors lie on one device.  ``(run_start, run_c)`` is
    ``pair_runs(pair_c)``, computed once by the caller, and every index is
    in range (``bsr_spgemm`` checks that; the executors build their lists
    in range).  On the CPU this is
    the plain version; on CUDA it launches the kernel (adding one to
    ``bsr_spgemm_local.launches["scalar_runs"]`` at b = 1, else to
    ``["block_runs"]``) or raises.  The result is in
    ``promote_types(a, b)``, accumulated in fp32; C blocks no pair touches
    are zero.
    """
    tensors = {
        "a_blocks": a_blocks,
        "b_blocks": b_blocks,
        "pair_a": pair_a,
        "pair_b": pair_b,
        "pair_c": pair_c,
        "run_start": run_start,
        "run_c": run_c,
    }
    device = a_blocks.device
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, a_blocks on {device}")
    if device.type == "cpu":
        return bsr_spgemm_ref(a_blocks, b_blocks, pair_a, pair_b, pair_c, n_c_blocks)
    if device.type != "cuda":
        raise ValueError(f"no BSR SpGEMM kernel for device type {device.type!r}")
    indices = [(k, tensors[k]) for k in ("pair_a", "pair_b", "run_start", "run_c")]
    b = _check_kernel_inputs(a_blocks, b_blocks, indices)
    out_dtype = torch.promote_types(a_blocks.dtype, b_blocks.dtype)
    # the kernel reads one element type: mixed inputs meet at the result type
    a_blocks = a_blocks.to(out_dtype)
    b_blocks = b_blocks.to(out_dtype)
    out = torch.zeros((n_c_blocks, b, b), dtype=out_dtype, device=device)
    n_runs = run_c.numel()
    if run_start.numel() != n_runs + 1:
        raise ValueError("run_start must hold n_runs + 1 offsets")
    if n_runs == 0:
        return out
    with torch.cuda.device(device):
        err = _kernel()(
            a_blocks.data_ptr(),
            b_blocks.data_ptr(),
            pair_a.data_ptr(),
            pair_b.data_ptr(),
            run_start.data_ptr(),
            run_c.data_ptr(),
            out.data_ptr(),
            n_runs,
            b,
            _DTYPE_CODE[out_dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bsr_spgemm kernel launch failed: CUDA error {err}")
    bsr_spgemm_local.launches["scalar_runs" if b == 1 else "block_runs"] += 1
    return out


# launches since the last reset, per __global__ of csrc/bsr_spgemm.cu
bsr_spgemm_local.launches = {"scalar_runs": 0, "block_runs": 0}
