"""What a configuration's generator hands the harness: structures and products.

Structures are canonical boolean CSR matrices (sorted indices, no
duplicates), the order in which the program takes a nonzero value vector.
A product names its two operands: a base operand, whose values the
generator makes, or an earlier product, whose dense result the traffic driver reads
back at that product's structure (a chain, as AMG's P^T (A P)).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass(frozen=True)
class Product:
    name: str
    a: str  # operand names: a base operand or an earlier product
    b: str


@dataclasses.dataclass
class Instance:
    structures: dict  # name -> canonical bool CSR, every operand and product
    products: list  # [Product], in the order a request runs them
    base: tuple  # operand names whose values the generator makes

    def chained(self, operand: str) -> bool:
        return any(p.name == operand for p in self.products)


def canonical(mat) -> sp.csr_matrix:
    """A canonical boolean CSR copy of ``mat``'s nonzero structure."""
    m = sp.csr_matrix(mat, copy=True)
    m.data = np.ones_like(m.data, dtype=bool)
    m.sum_duplicates()
    m.sort_indices()
    m.eliminate_zeros()
    return m


def from_coo(rows, cols, shape) -> sp.csr_matrix:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    return canonical(sp.coo_matrix((np.ones(len(rows), dtype=bool), (rows, cols)), shape=shape))


def symbolic_product(a: sp.csr_matrix, b: sp.csr_matrix) -> sp.csr_matrix:
    """The structure of A @ B, with no cancellation."""
    return canonical(a.astype(np.int8) @ b.astype(np.int8))


def transpose_order(s: sp.csr_matrix) -> np.ndarray:
    """``perm`` with ``values_of(s.T) == values_of(s)[perm]`` in canonical order."""
    pos = sp.csr_matrix((np.arange(1, s.nnz + 1, dtype=np.float64), s.indices, s.indptr),
                        shape=s.shape)
    t = sp.csr_matrix(pos.T)
    t.sort_indices()
    return t.data.astype(np.int64) - 1


def row_of_entries(s: sp.csr_matrix) -> np.ndarray:
    """The row index of every stored entry, in canonical order."""
    return np.repeat(np.arange(s.shape[0], dtype=np.int64), np.diff(s.indptr))
