"""An interior-point method's normal equations A D A^T (the paper's Sec. 6.2).

A frozen copy of the port's ``core/matrices.py:lp_constraint_matrix``, held
equal to it by ``tests/test_bench_generators.py``: a staircase
multicommodity-flow-like constraint structure (block diagonal plus a band of
shared coupling columns), the stand-in for pds-100's.  The product is
A (D A^T): B = D A^T has A^T's structure, its row k scaled by D's k-th entry.
"""
from __future__ import annotations

import numpy as np
import torch

from spgemm_bench.instance import (
    Instance,
    Product,
    canonical,
    from_coo,
    row_of_entries,
    symbolic_product,
    transpose_order,
)


def lp_constraint_matrix(
    n_rows: int,
    n_cols: int,
    nnz_per_row: float = 7.0,
    n_blocks: int = 8,
    coupling_cols: float = 0.05,
    seed: int = 0,
):
    """Staircase multicommodity-flow-like LP constraint structure: block
    diagonal (per-commodity flow constraints) plus a band of shared coupling
    columns, mimicking pds/fome instances (I < K, ~7 nnz/row)."""
    rng = np.random.default_rng(seed)
    rows_list, cols_list = [], []
    rb = np.linspace(0, n_rows, n_blocks + 1).astype(int)
    n_couple = int(n_cols * coupling_cols)
    cb = np.linspace(0, n_cols - n_couple, n_blocks + 1).astype(int)
    for b in range(n_blocks):
        r0, r1 = rb[b], rb[b + 1]
        c0, c1 = cb[b], cb[b + 1]
        rows = np.arange(r0, r1)
        # each row: ~nnz_per_row-1 entries in its block + 1 coupling entry
        k = max(int(nnz_per_row) - 1, 1)
        for _ in range(k):
            rows_list.append(rows)
            cols_list.append(rng.integers(c0, max(c1, c0 + 1), size=len(rows)))
        rows_list.append(rows)
        cols_list.append(
            n_cols - n_couple + rng.integers(0, max(n_couple, 1), size=len(rows))
        )
    return from_coo(
        np.concatenate(rows_list), np.concatenate(cols_list), (n_rows, n_cols)
    )


def build(cfg: dict) -> Instance:
    a = lp_constraint_matrix(cfg["rows"], cfg["cols"], cfg["nnz_per_row"], cfg["blocks"],
                             cfg["coupling_cols"], seed=cfg["structure_seed"])
    dat = canonical(a.T)
    return Instance(
        structures={"A": a, "DAT": dat, "ADAT": symbolic_product(a, dat)},
        products=[Product("ADAT", "A", "DAT")],
        base=("A", "DAT"),
    )


def values(cfg: dict, inst: Instance, count: int, gen: torch.Generator, device) -> list:
    """``count`` sets of one A's values (standard normal fp32) with a
    positive diagonal D each, log-uniform over ``cfg["d_decades"]`` decades
    around 1 (an interior-point iterate's x/s spread), made on ``device``."""
    s = inst.structures
    a = torch.randn(s["A"].nnz, generator=gen, device=device)
    half = cfg["d_decades"] / 2
    d = 10.0 ** (torch.rand((count, s["A"].shape[1]), generator=gen, device=device)
                 * (2 * half) - half)
    perm = torch.as_tensor(transpose_order(s["A"]), device=device)
    row = torch.as_tensor(row_of_entries(s["DAT"]), device=device)
    dat = d[:, row] * a[perm]
    return [{"A": a, "DAT": dat[i]} for i in range(count)]
