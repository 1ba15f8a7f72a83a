"""Block-sparse (BSR) tiling (a copy of ``repro.sparse.bsr``).

A b_r x b_c blocking of a sparse matrix is a vertex coarsening of the SpGEMM
hypergraph (DESIGN.md Sec. 3) and simultaneously the storage format consumed
by the BSR SpGEMM kernel.  Blocks are stored dense; the block index set is
the coarsened nonzero structure.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.structure import SparseStructure, from_coo


@dataclasses.dataclass(frozen=True)
class BlockSparse:
    """BSR matrix: dense blocks at sparse block coordinates.

    blocks:   (n_blocks, b_r, b_c) float array
    brows:    (n_blocks,) block-row index
    bcols:    (n_blocks,) block-col index
    shape:    logical (padded) shape, multiples of (b_r, b_c)
    """

    blocks: np.ndarray
    brows: np.ndarray
    bcols: np.ndarray
    shape: tuple[int, int]

    @property
    def block_shape(self) -> tuple[int, int]:
        return self.blocks.shape[1], self.blocks.shape[2]

    @property
    def n_blocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def grid(self) -> tuple[int, int]:
        b_r, b_c = self.block_shape
        return self.shape[0] // b_r, self.shape[1] // b_c

    def block_structure(self) -> SparseStructure:
        """Coarsened nonzero structure over the block grid."""
        return from_coo(self.brows, self.bcols, self.grid)


def to_bsr(dense: np.ndarray, b_r: int, b_c: int) -> BlockSparse:
    """Tile a dense array, keeping only blocks with any nonzero."""
    m, n = dense.shape
    pm = (m + b_r - 1) // b_r * b_r
    pn = (n + b_c - 1) // b_c * b_c
    padded = np.zeros((pm, pn), dtype=dense.dtype)
    padded[:m, :n] = dense
    g_r, g_c = pm // b_r, pn // b_c
    tiles = padded.reshape(g_r, b_r, g_c, b_c).transpose(0, 2, 1, 3)
    nz = np.argwhere(np.abs(tiles).sum(axis=(2, 3)) != 0)
    if len(nz) == 0:
        nz = np.zeros((1, 2), dtype=np.int64)  # keep one block: static shapes
    brows, bcols = nz[:, 0], nz[:, 1]
    blocks = tiles[brows, bcols]
    return BlockSparse(blocks, brows.astype(np.int64), bcols.astype(np.int64), (pm, pn))


def bsr_to_dense(bsr: BlockSparse) -> np.ndarray:
    b_r, b_c = bsr.block_shape
    out = np.zeros(bsr.shape, dtype=bsr.blocks.dtype)
    for blk, i, j in zip(bsr.blocks, bsr.brows, bsr.bcols):
        out[i * b_r : (i + 1) * b_r, j * b_c : (j + 1) * b_c] += blk
    return out

