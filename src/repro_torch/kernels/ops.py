"""The port's kernel entry point: ``spmm``, ``spgemm`` and ``grouped_gemm``.

Mirrors ``repro.kernels.ops``.  In place of JAX's ``interpret`` flag each
takes ``device``: ``None`` means the card and raises when there is none;
``device="cpu"`` runs the kernels' plain PyTorch versions.  Nothing falls
back: on the card a failed build or launch raises ``KernelError``.  The BSR entry points
take host-side ``BlockSparse`` matrices and run the inspector on the host.
Block values and dense operands may be numpy arrays (bfloat16 ones too, as
``ml_dtypes`` makes them) or tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.runtime import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.bsr_spgemm import bsr_spgemm, build_pair_lists
from repro_torch.kernels.bsr_spmm import bsr_spmm
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.sparse.bsr import BlockSparse

__all__ = [
    "bsr_spgemm_ref",
    "bsr_spmm_ref",
    "grouped_gemm",
    "moe_gemm_ref",
    "spgemm",
    "spmm",
]


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` from a tensor or an array; numpy bfloat16
    arrays are read bit for bit."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def spmm(bsr: BlockSparse, dense, device=None) -> torch.Tensor:
    """BSR x dense.  Pads a zero block into every empty block-row and sorts
    by block-row, as the reference does (the port's kernel writes empty
    rows itself, so the padding only keeps the two block lists equal)."""
    dev = resolve_device(device)
    m_blocks = bsr.shape[0] // bsr.block_shape[0]
    brows, bcols, blocks = bsr.brows, bsr.bcols, as_tensor(bsr.blocks, dev)
    missing = np.setdiff1d(np.arange(m_blocks), brows)
    if len(missing):
        b_m, b_k = bsr.block_shape
        blocks = torch.cat(
            [blocks, blocks.new_zeros((len(missing), b_m, b_k))]
        )
        brows = np.concatenate([brows, missing])
        bcols = np.concatenate([bcols, np.zeros(len(missing), np.int64)])
    order = np.argsort(brows, kind="stable")
    return bsr_spmm(
        blocks[torch.as_tensor(order, device=dev)],
        brows[order],
        bcols[order],
        as_tensor(dense, dev),
        m_blocks=m_blocks,
    )


def spgemm(
    a: BlockSparse, b: BlockSparse, device=None
) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """BSR x BSR -> (C blocks, c_brows, c_bcols).  Inspector on host."""
    dev = resolve_device(device)
    pa, pb, pc, crows, ccols = build_pair_lists(a.brows, a.bcols, b.brows, b.bcols)
    a_blocks = as_tensor(a.blocks, dev)
    if len(pa) == 0:
        bm, bn = a.block_shape[0], b.block_shape[1]
        return a_blocks.new_zeros((0, bm, bn)), crows, ccols
    out = bsr_spgemm(
        a_blocks,
        as_tensor(b.blocks, dev),
        pa,
        pb,
        pc,
        n_c_blocks=len(crows),
    )
    return out, crows, ccols


def grouped_gemm(x, w, device=None) -> torch.Tensor:
    """(E, C, d) x (E, d, f) -> (E, C, f), in x's type."""
    dev = resolve_device(device)
    return moe_gemm(as_tensor(x, dev), as_tensor(w, dev))


# re-export the plain versions for test convenience
bsr_spmm_ref = ref.bsr_spmm_ref
bsr_spgemm_ref = ref.bsr_spgemm_ref
moe_gemm_ref = ref.moe_gemm_ref
