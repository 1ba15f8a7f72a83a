"""The plain reference: each product again, in float64, with scipy.

Independent of the program: it takes the structures from the benchmark's own
generators and the values the benchmark made, and never anything the
program derived from them.  Beside each product it computes the magnitude
|A| |B| (chained through the products like the values), the scale against
which a computed entry's error is read: an fp32 sum of k products is off by
at most about k * 2^-24 of it.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def operand(structure: sp.csr_matrix, values) -> sp.csr_matrix:
    """``structure`` with ``values`` (canonical CSR order) as a float64 matrix."""
    values = np.asarray(values, dtype=np.float64)
    if values.shape != (structure.nnz,):
        raise ValueError(f"values of shape {values.shape} for {structure.nnz} nonzeros")
    return sp.csr_matrix((values, structure.indices, structure.indptr), shape=structure.shape)


def products(inst, base_values: dict) -> dict:
    """``{product: (reference, magnitude)}``, float64 CSR matrices, for the
    values ``base_values`` (``{operand: values}``) of one request."""
    done: dict = {}

    def resolve(name):
        if name in done:
            return done[name]
        m = operand(inst.structures[name], base_values[name])
        return m, abs(m)

    for prod in inst.products:
        (a, a_mag), (b, b_mag) = resolve(prod.a), resolve(prod.b)
        ref = sp.csr_matrix(a @ b)
        mag = sp.csr_matrix(a_mag @ b_mag)
        mag.eliminate_zeros()
        mag.sort_indices()
        done[prod.name] = (ref, mag)
    return done


def aligned(ref: sp.csr_matrix, mag: sp.csr_matrix) -> np.ndarray:
    """``ref``'s values at ``mag``'s entries (canonical order), 0 where
    ``ref`` stores none.  Every stored entry of ``ref`` lies in ``mag``'s
    structure, which holds every entry that has a product."""
    ref = sp.csr_matrix(ref)
    ref.sort_indices()
    n_cols = np.int64(mag.shape[1])
    key_mag = _row_of(mag) * n_cols + mag.indices
    key_ref = _row_of(ref) * n_cols + ref.indices
    at = np.searchsorted(key_mag, key_ref)
    if len(key_ref) and (at.max() >= len(key_mag) or (key_mag[at] != key_ref).any()):
        raise ValueError("the reference stores an entry outside its magnitude's structure")
    out = np.zeros(mag.nnz)
    out[at] = ref.data
    return out


def _row_of(m: sp.csr_matrix) -> np.ndarray:
    return np.repeat(np.arange(m.shape[0], dtype=np.int64), np.diff(m.indptr))
