"""Sparse-matrix substrate: structure containers, symbolic SpGEMM, BSR tiling
(copies of ``repro.sparse``)."""
from repro_torch.sparse.structure import (
    SparseStructure,
    as_structure,
    from_coo,
    from_dense,
    random_structure,
    spgemm_symbolic,
    structure_and_values,
    nontrivial_multiplications,
)
from repro_torch.sparse.bsr import BlockSparse, to_bsr, bsr_to_dense

__all__ = [
    "SparseStructure",
    "as_structure",
    "from_coo",
    "from_dense",
    "random_structure",
    "structure_and_values",
    "spgemm_symbolic",
    "nontrivial_multiplications",
    "BlockSparse",
    "to_bsr",
    "bsr_to_dense",
]
