"""SpGEMM hypergraph model builders.

Implements Def. 3.1 (fine-grained) and the six coarsened models of Sec. 5:
row-wise (RrR, Ex. 5.1), column-wise, outer-product (CRf, Ex. 5.2),
monochrome-A (Frf, Ex. 5.3), monochrome-B, monochrome-C (ffF, Ex. 5.4).

``include_nz`` toggles the nonzero vertices V^nz.  The paper's experiments
(Sec. 6) set delta = p-1 (no memory balance) and omit V^nz; the lower-bound
machinery (Sec. 4) keeps them.  Net costs and computational weights follow the
Examples exactly.

Vertex kinds: 0 = multiplication/coarsened-mult, 1/2/3 = A/B/C nonzero vertex.
Net kinds: 1/2/3 = A/B/C nets.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.core.hypergraph import Hypergraph, build_hypergraph_flat
from repro_torch.sparse.structure import (
    SparseStructure,
    nontrivial_multiplications,
    spgemm_symbolic,
)

MODELS = (
    "fine",
    "rowwise",
    "columnwise",
    "outer",
    "monoA",
    "monoB",
    "monoC",
)

# 1D models per the paper's classification (Sec. 5.2)
MODELS_1D = ("rowwise", "columnwise", "outer")
MODELS_2D = ("monoA", "monoB", "monoC")


def _lin_lookup(struct: SparseStructure, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Vectorized (row, col) -> CSR nonzero position lookup."""
    n_cols = struct.shape[1]
    r, c = struct.coo()
    lin_sorted = r * n_cols + c  # CSR order is sorted by (row, col)
    query = rows * n_cols + cols
    pos = np.searchsorted(lin_sorted, query)
    # out-of-range queries return len(lin_sorted); clip before the gather so
    # they fail the membership check below instead of raising IndexError
    safe = np.minimum(pos, max(len(lin_sorted) - 1, 0))
    if not len(lin_sorted) or not np.array_equal(lin_sorted[safe], query):
        if len(query):
            raise KeyError("query coordinates not all nonzero")
    return pos.astype(np.int64)


def _csc_to_csr_pos(struct: SparseStructure) -> tuple[np.ndarray, np.ndarray]:
    """Return (csc indptr, csr-position-per-csc-entry): lets the by-column
    iteration of the multiplication space recover CSR nonzero ids."""
    import scipy.sparse as sp

    csr = struct.csr
    tagged = sp.csr_matrix(
        (np.arange(csr.nnz, dtype=np.int64), csr.indices, csr.indptr),
        shape=csr.shape,
    )
    csc = tagged.tocsc()
    return csc.indptr.astype(np.int64), csc.data.astype(np.int64)


class SpGEMMInstance:
    """A (S_A, S_B) pair with the derived quantities every model needs."""

    def __init__(self, a: SparseStructure, b: SparseStructure, name: str = ""):
        if a.shape[1] != b.shape[0]:
            raise ValueError("inner dimensions disagree")
        self.a, self.b, self.name = a, b, name
        self.c = spgemm_symbolic(a, b)
        self.mult_i, self.mult_k, self.mult_j = nontrivial_multiplications(a, b)
        self.n_mult = len(self.mult_i)

    @classmethod
    def from_operands(cls, A, B, name: str = "") -> "SpGEMMInstance":
        """Build an instance from anything structure-shaped: dense arrays,
        scipy sparse matrices, or ``SparseStructure`` objects (values, if
        present, are ignored — the inspector is structure-only).  This is
        what ``repro.plan`` calls."""
        from repro_torch.sparse.structure import as_structure

        return cls(as_structure(A), as_structure(B), name=name)

    @property
    def shape(self) -> tuple[int, int, int]:
        return self.a.shape[0], self.a.shape[1], self.b.shape[1]

    # -- plan-facing accessors (cached) ------------------------------------
    # The model builders and the plan IR both need the multiplication space
    # expressed in CSR nonzero ids and A in CSC form; cache them so the
    # inspector does each index computation once per instance.
    @functools.cached_property
    def a_csc(self):
        """A in CSC form (column-major iteration of the multiplication space)."""
        return self.a.tocsc()

    @functools.cached_property
    def mult_a_pos(self) -> np.ndarray:
        """CSR nonzero id of a_ik for every multiplication triple."""
        return _lin_lookup(self.a, self.mult_i, self.mult_k)

    @functools.cached_property
    def mult_b_pos(self) -> np.ndarray:
        """CSR nonzero id of b_kj for every multiplication triple."""
        return _lin_lookup(self.b, self.mult_k, self.mult_j)

    @functools.cached_property
    def mult_c_pos(self) -> np.ndarray:
        """CSR nonzero id of c_ij for every multiplication triple."""
        return _lin_lookup(self.c, self.mult_i, self.mult_j)

    def stats(self) -> dict:
        """Table II row."""
        I, K, J = self.shape
        return {
            "name": self.name,
            "I": I,
            "K": K,
            "J": J,
            "nnzA_per_row": self.a.nnz / I,
            "nnzB_per_row": self.b.nnz / K,
            "nnzC_per_row": self.c.nnz / I,
            "mult_per_C_nnz": self.n_mult / max(self.c.nnz, 1),
        }


def build_model(inst: SpGEMMInstance, model: str, include_nz: bool = False) -> Hypergraph:
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; choose from {MODELS}")
    return globals()[f"_build_{model}"](inst, include_nz)


# ---------------------------------------------------------------------------
# Fine-grained (Def. 3.1)
# ---------------------------------------------------------------------------
def _build_fine(inst: SpGEMMInstance, include_nz: bool) -> Hypergraph:
    a, b, c = inst.a, inst.b, inst.c
    M = inst.n_mult
    nA, nB, nC = a.nnz, b.nnz, c.nnz

    # net ids: A nets [0, nA), B nets [nA, nA+nB), C nets [nA+nB, nA+nB+nC)
    a_pos = inst.mult_a_pos
    b_pos = inst.mult_b_pos
    c_pos = inst.mult_c_pos

    mult_ids = np.arange(M, dtype=np.int64)
    net_ids = [a_pos, nA + b_pos, nA + nB + c_pos]
    pin_vs = [mult_ids, mult_ids, mult_ids]

    n_vertices = M
    if include_nz:
        vA = M + np.arange(nA, dtype=np.int64)
        vB = M + nA + np.arange(nB, dtype=np.int64)
        vC = M + nA + nB + np.arange(nC, dtype=np.int64)
        net_ids += [
            np.arange(nA, dtype=np.int64),
            nA + np.arange(nB, dtype=np.int64),
            nA + nB + np.arange(nC, dtype=np.int64),
        ]
        pin_vs += [vA, vB, vC]
        n_vertices = M + nA + nB + nC

    w_comp = np.zeros(n_vertices, dtype=np.int64)
    w_comp[:M] = 1
    w_mem = np.zeros(n_vertices, dtype=np.int64)
    if include_nz:
        w_mem[M:] = 1

    vertex_kind = np.zeros(n_vertices, dtype=np.int8)
    if include_nz:
        vertex_kind[M : M + nA] = 1
        vertex_kind[M + nA : M + nA + nB] = 2
        vertex_kind[M + nA + nB :] = 3
    net_kind = np.concatenate(
        [
            np.full(nA, 1, dtype=np.int8),
            np.full(nB, 2, dtype=np.int8),
            np.full(nC, 3, dtype=np.int8),
        ]
    )
    return build_hypergraph_flat(
        np.concatenate(net_ids),
        np.concatenate(pin_vs),
        nA + nB + nC,
        n_vertices,
        w_comp,
        w_mem,
        np.ones(nA + nB + nC, dtype=np.int64),
        vertex_kind=vertex_kind,
        net_kind=net_kind,
        name=f"fine({inst.name})",
    )


# ---------------------------------------------------------------------------
# 1D: row-wise (RrR), Ex. 5.1
# ---------------------------------------------------------------------------
def _build_rowwise(inst: SpGEMMInstance, include_nz: bool) -> Hypergraph:
    a, b, c = inst.a, inst.b, inst.c
    I, K, J = inst.shape
    b_row_nnz = b.row_counts()
    # vertices: v_i (i in [I]) [+ v^B_k]
    n_vertices = I + (K if include_nz else 0)
    # nets: n^B_k = {v_i : (i,k) in S_A} [+ {v^B_k}]; cost = nnz(B row k)
    acsc = inst.a_csc
    net_ids = np.repeat(np.arange(K, dtype=np.int64), np.diff(acsc.indptr))
    pin_vs = acsc.indices.astype(np.int64)
    if include_nz:
        net_ids = np.concatenate([net_ids, np.arange(K, dtype=np.int64)])
        pin_vs = np.concatenate([pin_vs, I + np.arange(K, dtype=np.int64)])

    w_comp = np.zeros(n_vertices, dtype=np.int64)
    # flops of row i = sum_{k in A row i} nnz(B row k)
    row_flops = a.csr.astype(np.int64) @ b_row_nnz
    w_comp[:I] = row_flops
    w_mem = np.zeros(n_vertices, dtype=np.int64)
    w_mem[:I] = a.row_counts() + c.row_counts()
    if include_nz:
        w_mem[I:] = b_row_nnz

    vertex_kind = np.zeros(n_vertices, dtype=np.int8)
    if include_nz:
        vertex_kind[I:] = 2
    return build_hypergraph_flat(
        net_ids,
        pin_vs,
        K,
        n_vertices,
        w_comp,
        w_mem,
        b_row_nnz.astype(np.int64),
        vertex_kind=vertex_kind,
        net_kind=np.full(K, 2, dtype=np.int8),
        name=f"rowwise({inst.name})",
    )


# ---------------------------------------------------------------------------
# 1D: column-wise (symmetric to row-wise via C^T = B^T A^T)
# ---------------------------------------------------------------------------
def _build_columnwise(inst: SpGEMMInstance, include_nz: bool) -> Hypergraph:
    a, b, c = inst.a, inst.b, inst.c
    I, K, J = inst.shape
    a_col_nnz = a.col_counts()
    # vertices: v_j (j in [J]) [+ v^A_k (columns of A)]
    n_vertices = J + (K if include_nz else 0)
    # nets: n^A_k = {v_j : (k,j) in S_B} [+ {v^A_k}]; cost = nnz(A col k)
    bcsr = b.csr
    net_ids = np.repeat(np.arange(K, dtype=np.int64), np.diff(bcsr.indptr))
    pin_vs = bcsr.indices.astype(np.int64)
    if include_nz:
        net_ids = np.concatenate([net_ids, np.arange(K, dtype=np.int64)])
        pin_vs = np.concatenate([pin_vs, J + np.arange(K, dtype=np.int64)])

    w_comp = np.zeros(n_vertices, dtype=np.int64)
    col_flops = b.csr.T.astype(np.int64) @ a_col_nnz  # per column j of B
    w_comp[:J] = np.asarray(col_flops).ravel()
    w_mem = np.zeros(n_vertices, dtype=np.int64)
    w_mem[:J] = b.col_counts() + c.col_counts()
    if include_nz:
        w_mem[J:] = a_col_nnz

    vertex_kind = np.zeros(n_vertices, dtype=np.int8)
    if include_nz:
        vertex_kind[J:] = 1
    return build_hypergraph_flat(
        net_ids,
        pin_vs,
        K,
        n_vertices,
        w_comp,
        w_mem,
        a_col_nnz.astype(np.int64),
        vertex_kind=vertex_kind,
        net_kind=np.full(K, 1, dtype=np.int8),
        name=f"columnwise({inst.name})",
    )


# ---------------------------------------------------------------------------
# 1D: outer-product (CRf), Ex. 5.2
# ---------------------------------------------------------------------------
def _build_outer(inst: SpGEMMInstance, include_nz: bool) -> Hypergraph:
    a, b, c = inst.a, inst.b, inst.c
    I, K, J = inst.shape
    nC = c.nnz
    # vertices: v_k [+ v^C_ij]
    n_vertices = K + (nC if include_nz else 0)
    # nets: n^C_ij = {v_k : contributes to (i,j)} [+ {v^C_ij}]; cost 1.
    c_pos = inst.mult_c_pos
    # dedupe (k contributes once per (i,j) even though pins derive from mults)
    pair = c_pos * K + inst.mult_k
    uniq = np.unique(pair)
    net_ids = uniq // K
    pin_vs = uniq % K
    if include_nz:
        net_ids = np.concatenate([net_ids, np.arange(nC, dtype=np.int64)])
        pin_vs = np.concatenate([pin_vs, K + np.arange(nC, dtype=np.int64)])

    w_comp = np.zeros(n_vertices, dtype=np.int64)
    w_comp[:K] = a.col_counts() * b.row_counts()
    w_mem = np.zeros(n_vertices, dtype=np.int64)
    w_mem[:K] = a.col_counts() + b.row_counts()
    if include_nz:
        w_mem[K:] = 1

    vertex_kind = np.zeros(n_vertices, dtype=np.int8)
    if include_nz:
        vertex_kind[K:] = 3
    return build_hypergraph_flat(
        net_ids,
        pin_vs,
        nC,
        n_vertices,
        w_comp,
        w_mem,
        np.ones(nC, dtype=np.int64),
        vertex_kind=vertex_kind,
        net_kind=np.full(nC, 3, dtype=np.int8),
        name=f"outer({inst.name})",
    )


# ---------------------------------------------------------------------------
# 2D: monochrome-A (Frf), Ex. 5.3
# ---------------------------------------------------------------------------
def _build_monoA(inst: SpGEMMInstance, include_nz: bool) -> Hypergraph:
    a, b, c = inst.a, inst.b, inst.c
    I, K, J = inst.shape
    nA, nC = a.nnz, c.nnz
    b_row_nnz = b.row_counts()
    # vertices: v_ik ((i,k) in S_A) [+ v^B_k + v^C_ij]
    n_vertices = nA + ((K + nC) if include_nz else 0)

    # nets n^B_k = {v_ik : (i,k) in S_A}, cost nnz(B row k)
    csc_ptr, csr_pos = _csc_to_csr_pos(a)
    netB_ids = np.repeat(np.arange(K, dtype=np.int64), np.diff(csc_ptr))
    netB_pins = csr_pos
    # nets n^C_ij = {v_ik : k contributes to (i,j)}, cost 1 — from mult triples
    a_pos = inst.mult_a_pos
    c_pos = inst.mult_c_pos
    netC_ids = K + c_pos
    netC_pins = a_pos

    net_ids = [netB_ids, netC_ids]
    pin_vs = [netB_pins, netC_pins]
    if include_nz:
        net_ids += [np.arange(K, dtype=np.int64), K + np.arange(nC, dtype=np.int64)]
        pin_vs += [
            nA + np.arange(K, dtype=np.int64),
            nA + K + np.arange(nC, dtype=np.int64),
        ]

    w_comp = np.zeros(n_vertices, dtype=np.int64)
    ar, ac = a.coo()
    w_comp[:nA] = b_row_nnz[ac]
    w_mem = np.zeros(n_vertices, dtype=np.int64)
    w_mem[:nA] = 1
    if include_nz:
        w_mem[nA : nA + K] = b_row_nnz
        w_mem[nA + K :] = 1

    vertex_kind = np.zeros(n_vertices, dtype=np.int8)
    if include_nz:
        vertex_kind[nA : nA + K] = 2
        vertex_kind[nA + K :] = 3
    net_cost = np.concatenate([b_row_nnz.astype(np.int64), np.ones(nC, dtype=np.int64)])
    net_kind = np.concatenate([np.full(K, 2, dtype=np.int8), np.full(nC, 3, dtype=np.int8)])
    return build_hypergraph_flat(
        np.concatenate(net_ids),
        np.concatenate(pin_vs),
        K + nC,
        n_vertices,
        w_comp,
        w_mem,
        net_cost,
        vertex_kind=vertex_kind,
        net_kind=net_kind,
        name=f"monoA({inst.name})",
    )


# ---------------------------------------------------------------------------
# 2D: monochrome-B (symmetric to monochrome-A)
# ---------------------------------------------------------------------------
def _build_monoB(inst: SpGEMMInstance, include_nz: bool) -> Hypergraph:
    a, b, c = inst.a, inst.b, inst.c
    I, K, J = inst.shape
    nB, nC = b.nnz, c.nnz
    a_col_nnz = a.col_counts()
    # vertices: v_kj ((k,j) in S_B) [+ v^A_k (col) + v^C_ij]
    n_vertices = nB + ((K + nC) if include_nz else 0)

    # nets n^A_k = {v_kj : (k,j) in S_B}, cost nnz(A col k) — rows of B
    bcsr = b.csr
    netA_ids = np.repeat(np.arange(K, dtype=np.int64), np.diff(bcsr.indptr))
    netA_pins = np.arange(nB, dtype=np.int64)  # CSR order groups by row k
    # nets n^C_ij = {v_kj : k contributes}, cost 1
    b_pos = inst.mult_b_pos
    c_pos = inst.mult_c_pos
    netC_ids = K + c_pos
    netC_pins = b_pos

    net_ids = [netA_ids, netC_ids]
    pin_vs = [netA_pins, netC_pins]
    if include_nz:
        net_ids += [np.arange(K, dtype=np.int64), K + np.arange(nC, dtype=np.int64)]
        pin_vs += [
            nB + np.arange(K, dtype=np.int64),
            nB + K + np.arange(nC, dtype=np.int64),
        ]

    w_comp = np.zeros(n_vertices, dtype=np.int64)
    br, bc = b.coo()
    w_comp[:nB] = a_col_nnz[br]
    w_mem = np.zeros(n_vertices, dtype=np.int64)
    w_mem[:nB] = 1
    if include_nz:
        w_mem[nB : nB + K] = a_col_nnz
        w_mem[nB + K :] = 1

    vertex_kind = np.zeros(n_vertices, dtype=np.int8)
    if include_nz:
        vertex_kind[nB : nB + K] = 1
        vertex_kind[nB + K :] = 3
    net_cost = np.concatenate([a_col_nnz.astype(np.int64), np.ones(nC, dtype=np.int64)])
    net_kind = np.concatenate([np.full(K, 1, dtype=np.int8), np.full(nC, 3, dtype=np.int8)])
    return build_hypergraph_flat(
        np.concatenate(net_ids),
        np.concatenate(pin_vs),
        K + nC,
        n_vertices,
        w_comp,
        w_mem,
        net_cost,
        vertex_kind=vertex_kind,
        net_kind=net_kind,
        name=f"monoB({inst.name})",
    )


# ---------------------------------------------------------------------------
# 2D: monochrome-C (ffF), Ex. 5.4
# ---------------------------------------------------------------------------
def _build_monoC(inst: SpGEMMInstance, include_nz: bool) -> Hypergraph:
    a, b, c = inst.a, inst.b, inst.c
    I, K, J = inst.shape
    nA, nB, nC = a.nnz, b.nnz, c.nnz
    # vertices: v_ij ((i,j) in S_C) [+ v^A_ik + v^B_kj]
    n_vertices = nC + ((nA + nB) if include_nz else 0)

    a_pos = inst.mult_a_pos
    b_pos = inst.mult_b_pos
    c_pos = inst.mult_c_pos
    # nets n^A_ik = {v_ij : (k,j) in S_B}, cost 1 (dedupe per (ik, ij))
    pairA = np.unique(a_pos * nC + c_pos)
    netA_ids, netA_pins = pairA // nC, pairA % nC
    # nets n^B_kj = {v_ij : (i,k) in S_A}, cost 1
    pairB = np.unique(b_pos * nC + c_pos)
    netB_ids, netB_pins = pairB // nC, pairB % nC

    net_ids = [netA_ids, nA + netB_ids]
    pin_vs = [netA_pins, netB_pins]
    if include_nz:
        net_ids += [np.arange(nA, dtype=np.int64), nA + np.arange(nB, dtype=np.int64)]
        pin_vs += [
            nC + np.arange(nA, dtype=np.int64),
            nC + nA + np.arange(nB, dtype=np.int64),
        ]

    w_comp = np.zeros(n_vertices, dtype=np.int64)
    w_comp[:nC] = np.bincount(c_pos, minlength=nC)  # k-count per (i,j)
    w_mem = np.ones(n_vertices, dtype=np.int64) if include_nz else np.zeros(
        n_vertices, dtype=np.int64
    )
    if not include_nz:
        w_mem[:nC] = 1

    vertex_kind = np.full(n_vertices, 3, dtype=np.int8)
    vertex_kind[:nC] = 0  # coarsened mult+C vertices
    if include_nz:
        vertex_kind[nC : nC + nA] = 1
        vertex_kind[nC + nA :] = 2
    net_kind = np.concatenate([np.full(nA, 1, dtype=np.int8), np.full(nB, 2, dtype=np.int8)])
    return build_hypergraph_flat(
        np.concatenate(net_ids),
        np.concatenate(pin_vs),
        nA + nB,
        n_vertices,
        w_comp,
        w_mem,
        np.ones(nA + nB, dtype=np.int64),
        vertex_kind=vertex_kind,
        net_kind=net_kind,
        name=f"monoC({inst.name})",
    )
