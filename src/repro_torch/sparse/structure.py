"""Nonzero-structure containers and symbolic SpGEMM.

A copy of ``repro.sparse.structure`` (the port imports nothing of the JAX
package); the planning tests pin both to identical results.  The paper
(Sec. 3.1) works purely with nonzero structures S_A, S_B and the induced S_C
(no numerical cancellation).  ``SparseStructure`` is a thin,
immutable wrapper around a deduplicated, sorted boolean CSR matrix.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass(frozen=True)
class SparseStructure:
    """Immutable nonzero structure of a sparse matrix."""

    csr: sp.csr_matrix  # bool data, canonical (sorted indices, no dups)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def wrap(mat: sp.spmatrix) -> "SparseStructure":
        m = sp.csr_matrix(mat, copy=True)
        m.data = np.ones_like(m.data, dtype=bool)
        m.sum_duplicates()
        m.sort_indices()
        m.eliminate_zeros()
        return SparseStructure(m)

    # -- basic properties --------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return self.csr.shape

    @property
    def nnz(self) -> int:
        return int(self.csr.nnz)

    @property
    def indptr(self) -> np.ndarray:
        return self.csr.indptr

    @property
    def indices(self) -> np.ndarray:
        return self.csr.indices

    def row_counts(self) -> np.ndarray:
        return np.diff(self.csr.indptr)

    def col_counts(self) -> np.ndarray:
        return np.asarray(
            self.csr.astype(np.int64).sum(axis=0)
        ).ravel()

    def transpose(self) -> "SparseStructure":
        return SparseStructure.wrap(self.csr.T)

    def tocsc(self) -> sp.csc_matrix:
        return self.csr.tocsc()

    def coo(self) -> tuple[np.ndarray, np.ndarray]:
        c = self.csr.tocoo()
        return c.row.astype(np.int64), c.col.astype(np.int64)

    # nnz are identified by their CSR position: nz_id(i, k) = position of
    # (i, k) within the CSR data array.  This is the canonical net/vertex
    # numbering used by the hypergraph builders.
    def nz_ids(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """Map (row, col) coordinate arrays to CSR nonzero positions."""
        out = np.empty(len(rows), dtype=np.int64)
        indptr, indices = self.csr.indptr, self.csr.indices
        for n, (i, k) in enumerate(zip(rows, cols)):
            lo, hi = indptr[i], indptr[i + 1]
            pos = lo + np.searchsorted(indices[lo:hi], k)
            if pos >= hi or indices[pos] != k:
                raise KeyError(f"({i},{k}) not a nonzero")
            out[n] = pos
        return out

    def has_empty_rows_or_cols(self) -> bool:
        return bool((self.row_counts() == 0).any() or (self.col_counts() == 0).any())

    def __eq__(self, other: object) -> bool:  # structural equality
        if not isinstance(other, SparseStructure):
            return NotImplemented
        return (
            self.shape == other.shape
            and self.nnz == other.nnz
            and np.array_equal(self.indptr, other.indptr)
            and np.array_equal(self.indices, other.indices)
        )


def structure_fingerprint(s: SparseStructure) -> str:
    """Content hash of a nonzero structure, memoized on the object (the
    runtime's executor-cache key)."""
    fp = s.__dict__.get("_fingerprint")
    if fp is None:
        h = hashlib.sha1(f"{s.shape}".encode())
        h.update(np.ascontiguousarray(s.indptr))
        h.update(np.ascontiguousarray(s.indices))
        fp = h.hexdigest()
        object.__setattr__(s, "_fingerprint", fp)  # frozen dataclass
    return fp


def from_coo(rows, cols, shape) -> SparseStructure:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    m = sp.coo_matrix((np.ones(len(rows), dtype=bool), (rows, cols)), shape=shape)
    return SparseStructure.wrap(m)


def from_dense(arr) -> SparseStructure:
    return SparseStructure.wrap(sp.csr_matrix(np.asarray(arr) != 0))


def as_structure(x) -> SparseStructure:
    """Normalize to a ``SparseStructure``: accepts a structure (returned
    as-is), any scipy sparse matrix, or a dense array."""
    if isinstance(x, SparseStructure):
        return x
    if sp.issparse(x):
        return SparseStructure.wrap(sp.csr_matrix(x))
    return from_dense(x)


def structure_and_values(x) -> tuple[SparseStructure, np.ndarray]:
    """Normalize an operand to (structure, values-in-canonical-CSR-order).

    Accepts a dense ndarray, any scipy sparse matrix, or an
    ``(SparseStructure, values)`` pair whose values already follow the
    structure's CSR order — sparse callers never round-trip through dense.
    """
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], SparseStructure):
        s, vals = x
        vals = np.asarray(vals)
        if vals.shape != (s.nnz,):
            raise ValueError(
                f"values shape {vals.shape} does not match structure nnz {s.nnz}"
            )
        return s, vals
    if sp.issparse(x):
        m = sp.csr_matrix(x, copy=True)
        m.sum_duplicates()
        m.sort_indices()
        return SparseStructure.wrap(m), np.asarray(m.data)
    m = sp.csr_matrix(np.asarray(x))
    return SparseStructure.wrap(m), np.asarray(m.data)


def random_structure(
    n_rows: int,
    n_cols: int,
    density: float,
    rng: np.random.Generator,
    ensure_nonempty: bool = True,
) -> SparseStructure:
    """Erdős–Rényi structure; optionally patch empty rows/cols (Sec. 3.1
    assumes no zero rows/columns in A or B)."""
    mask = rng.random((n_rows, n_cols)) < density
    if ensure_nonempty:
        for i in np.flatnonzero(~mask.any(axis=1)):
            mask[i, rng.integers(n_cols)] = True
        for j in np.flatnonzero(~mask.any(axis=0)):
            mask[rng.integers(n_rows), j] = True
    return from_dense(mask)


def spgemm_symbolic(a: SparseStructure, b: SparseStructure) -> SparseStructure:
    """S_C induced by S_A, S_B (no cancellation)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    c = (a.csr.astype(np.int8) @ b.csr.astype(np.int8))
    return SparseStructure.wrap(c)


def nontrivial_multiplications(
    a: SparseStructure, b: SparseStructure
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (i, k, j) with a_ik != 0 and b_kj != 0, ordered by k then by the
    CSR order within A's column k and B's row k.

    Returns (i, k, j) int64 arrays of length |V^m|.  This is the iteration
    space of Fig. 2 and the multiplication-vertex set of Def. 3.1.
    """
    acsc = a.tocsc()
    bcsr = b.csr
    K = a.shape[1]
    a_cnt = np.diff(acsc.indptr)  # nnz per column of A
    b_cnt = np.diff(bcsr.indptr)  # nnz per row of B
    per_k = a_cnt * b_cnt
    total = int(per_k.sum())
    ii = np.empty(total, dtype=np.int64)
    kk = np.empty(total, dtype=np.int64)
    jj = np.empty(total, dtype=np.int64)
    pos = 0
    for k in range(K):
        na, nb = int(a_cnt[k]), int(b_cnt[k])
        if na == 0 or nb == 0:
            continue
        rows = acsc.indices[acsc.indptr[k] : acsc.indptr[k + 1]]
        cols = bcsr.indices[bcsr.indptr[k] : bcsr.indptr[k + 1]]
        n = na * nb
        ii[pos : pos + n] = np.repeat(rows, nb)
        kk[pos : pos + n] = k
        jj[pos : pos + n] = np.tile(cols, na)
        pos += n
    return ii[:pos], kk[:pos], jj[:pos]


def flops(a: SparseStructure, b: SparseStructure) -> int:
    """|V^m| = number of nontrivial multiplications."""
    return int((a.col_counts() * b.row_counts()).sum())
