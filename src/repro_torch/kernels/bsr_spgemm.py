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
CUDA device it launches the kernel or raises ``KernelError``.  ``bsr_spgemm`` keeps the JAX
package's signature and derives the runs from ``pair_c`` itself.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels._build import DTYPE_CODE, KernelError, as_index, check_inputs, load
from repro_torch.kernels.ref import bsr_spgemm_ref


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
        as_index(pair_a, dev),
        as_index(pair_b, dev),
        as_index(pair_c, dev),
        as_index(run_start, dev),
        as_index(run_c, dev),
        n_c_blocks,
    )


# the __global__s of csrc/bsr_spgemm.cu, numbered as its C entry point
# repro_bsr_spgemm(kernel, a, b, pair_a, pair_b, run_start, run_c, out, n_runs,
# n_pairs, n_c, bm, bk, bn, dtype code, stream) takes them
KERNELS = ("scalar_runs", "warp_runs", "tile_runs", "mma_runs")


@functools.cache
def _kernel():
    """The kernels' C entry point, built and bound on first use."""
    fn = load("bsr_spgemm").repro_bsr_spgemm
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def route(bm: int, bk: int, bn: int) -> str:
    """The kernel ``bsr_spgemm_local`` launches for (bm, bk) A blocks and
    (bk, bn) B blocks on the card, decided before the launch.

    ``"scalar_runs"`` at 1 x 1 x 1 (each warp takes a fixed span of pairs
    and owns the runs that start there; a lane adds a group of 4 pairs of
    a run, counted from its start, the groups of a piece of 128 pairs are
    summed by shuffles within the warp and a run's pieces are added in
    order; every C slot is written);
    ``"warp_runs"`` (each warp walks a few
    runs' pairs as one stream, the next pair's blocks in flight) where bm,
    bn and bk are at most 16; ``"mma_runs"`` (wgmma tiles, fp32 as three bf16 pieces)
    where bm or bn is over 32; ``"tile_runs"`` for the rest (a side of 17 to
    32, or bk over 16): a warp keeps a run's C tile of up to 32 x 32 in
    registers and walks its runs' pairs 128 bytes of k at a time, the next
    two steps in flight, on fp32 FMAs or, for 16-bit, ``mma.sync``."""
    if bm == bk == bn == 1:
        return "scalar_runs"
    if max(bm, bk, bn) <= 16:
        return "warp_runs"
    if max(bm, bn) > 32:
        return "mma_runs"
    return "tile_runs"


def launch(a_blocks, b_blocks, pair_a, pair_b, run_start, run_c, out) -> str:
    """Launch the kernel ``route`` names for these blocks on CUDA tensors
    checked as ``bsr_spgemm_local`` checks them, summing into ``out``
    (zeroed by the caller, except on ``scalar_runs``, which writes every C
    slot); raise ``KernelError`` if it is refused, else return the kernel's
    name.  Counts nothing: ``bsr_spgemm_local`` counts its launches."""
    bm, bk, bn = _block_shapes(a_blocks, b_blocks)
    kernel = route(bm, bk, bn)
    device = a_blocks.device
    with torch.cuda.device(device):
        err = _kernel()(
            KERNELS.index(kernel),
            a_blocks.data_ptr(),
            b_blocks.data_ptr(),
            pair_a.data_ptr(),
            pair_b.data_ptr(),
            run_start.data_ptr(),
            run_c.data_ptr(),
            out.data_ptr(),
            run_c.numel(),
            pair_a.numel(),
            out.shape[0],
            bm,
            bk,
            bn,
            DTYPE_CODE[out.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise KernelError(f"bsr_spgemm kernel {kernel} launch failed: CUDA error {err}")
    return kernel


def _block_shapes(a_blocks, b_blocks) -> tuple[int, int, int]:
    """(bm, bk, bn) of (n, bm, bk) A blocks and (n, bk, bn) B blocks."""
    if a_blocks.ndim != 3 or b_blocks.ndim != 3:
        raise ValueError("a_blocks and b_blocks must be (n, rows, cols) block stacks")
    _, bm, bk = a_blocks.shape
    if b_blocks.shape[1] != bk:
        raise ValueError(
            f"A blocks {tuple(a_blocks.shape[1:])} and B blocks "
            f"{tuple(b_blocks.shape[1:])} disagree on the inner size"
        )
    return bm, bk, b_blocks.shape[2]


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
    """``C[pair_c[i]] += A[pair_a[i]] @ B[pair_b[i]]`` -> (n_c_blocks, bm, bn).

    All tensors lie on one device.  A blocks are (bm, bk) and B blocks
    (bk, bn), of any size.  ``(run_start, run_c)`` is
    ``pair_runs(pair_c)``, computed once by the caller, and every index is
    in range (``bsr_spgemm`` checks that; the executors build their lists
    in range).  On the CPU this is the plain version; on CUDA it launches
    the kernel ``route(bm, bk, bn)`` names (adding one to
    ``bsr_spgemm_local.launches[kernel]``) or raises ``KernelError``.  The result is in
    ``promote_types(a, b)``, accumulated in fp32; C blocks no pair touches
    are zero (``scalar_runs`` writes them, so C is allocated without a fill
    there).
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
    bm, bk, bn = _block_shapes(a_blocks, b_blocks)
    if device.type == "cpu":
        return bsr_spgemm_ref(a_blocks, b_blocks, pair_a, pair_b, pair_c, n_c_blocks)
    if device.type != "cuda":
        raise ValueError(f"no BSR SpGEMM kernel for device type {device.type!r}")
    check_inputs(
        [("a_blocks", a_blocks), ("b_blocks", b_blocks)],
        [(k, tensors[k]) for k in ("pair_a", "pair_b", "run_start", "run_c")],
    )
    out_dtype = torch.promote_types(a_blocks.dtype, b_blocks.dtype)
    # the kernel reads one element type: mixed inputs meet at the result type
    a_blocks = a_blocks.to(out_dtype)
    b_blocks = b_blocks.to(out_dtype)
    n_runs = run_c.numel()
    if run_start.numel() != n_runs + 1:
        raise KernelError("run_start must hold n_runs + 1 offsets")
    fills = n_runs == 0 or route(bm, bk, bn) != "scalar_runs"
    out = (torch.zeros if fills else torch.empty)(
        (n_c_blocks, bm, bn), dtype=out_dtype, device=device)
    if n_runs == 0:
        return out
    kernel = launch(a_blocks, b_blocks, pair_a, pair_b, run_start, run_c, out)
    bsr_spgemm_local.launches[kernel] += 1
    return out


# launches since the last reset, per __global__ of csrc/bsr_spgemm.cu
bsr_spgemm_local.launches = {name: 0 for name in KERNELS}
