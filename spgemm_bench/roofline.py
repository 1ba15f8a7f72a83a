"""The least time a product can take on a card, from its structures alone.

Counted from the instance's canonical structures, never from a plan, its
pair lists or its tables, so every way of computing the product is held to
the same work:

- bytes of the local product (K1): A's and B's values and CSR structures
  (int32 row pointers and column indices) read once, C's nonzero values
  written once;
- bytes of the whole product: the same reads, and the dense C that the
  handle returns (I x J values) written once;
- operations: 2 per scalar multiply-add, sum_k nnz(A[:, k]) * nnz(B[k, :]).

The least time is the larger of bytes over the memory bandwidth and
operations over the fp32 (non-tensor-core) peak, from the card's data sheet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

INDEX_BYTES = 4

# published dense peaks: NVIDIA H100 SXM5 data sheet (fp32 outside the
# tensor cores, HBM3 bandwidth), at the card's full 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "bytes_per_s": 3.35e12},
}


@dataclasses.dataclass(frozen=True)
class Counts:
    flops: int
    k1_bytes: int
    product_bytes: int


def csr_bytes(s, value_bytes: int) -> int:
    return s.nnz * value_bytes + (s.shape[0] + 1 + s.nnz) * INDEX_BYTES


def multiply_adds(a, b) -> int:
    """sum over k of nnz(A[:, k]) * nnz(B[k, :])."""
    col_a = np.bincount(a.indices, minlength=a.shape[1]).astype(np.int64)
    row_b = np.diff(b.indptr).astype(np.int64)
    return int(col_a @ row_b)


def counts(a, b, c, value_bytes: int = 4) -> Counts:
    """The counts of C = A B for canonical structures ``a``, ``b`` and C's
    structure ``c``."""
    reads = csr_bytes(a, value_bytes) + csr_bytes(b, value_bytes)
    return Counts(
        flops=2 * multiply_adds(a, b),
        k1_bytes=reads + c.nnz * value_bytes,
        product_bytes=reads + c.shape[0] * c.shape[1] * value_bytes,
    )


def instance_counts(inst, value_bytes: int = 4) -> dict:
    """``{product: Counts}`` of a generator's instance."""
    s = inst.structures
    return {p.name: counts(s[p.a], s[p.b], s[p.name], value_bytes) for p in inst.products}


def least_seconds(flops: int, n_bytes: int, kind: str) -> float | None:
    """max(bytes / bandwidth, operations / peak) on a card of ``kind``; None
    for a card the table does not hold."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return max(n_bytes / peak["bytes_per_s"], flops / peak["fp32_flops"])
