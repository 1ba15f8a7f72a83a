"""AMG setup's Galerkin products A P and P^T (A P) (the paper's Sec. 6.1).

Frozen copies of the port's ``core/matrices.py`` generators (``stencil27``,
``tentative_prolongator``, ``smoothed_prolongator``), held equal to them by
``tests/test_bench_generators.py``: the 27-point stencil on an n^3 grid, an
agg^3 aggregation and its degree-d smoothing, structure only.
"""
from __future__ import annotations

import numpy as np
import torch

from spgemm_bench.instance import (
    Instance,
    Product,
    canonical,
    from_coo,
    symbolic_product,
    transpose_order,
)


def stencil27(n: int):
    """27-point stencil on an n x n x n grid (row per grid point)."""
    idx = np.arange(n**3).reshape(n, n, n)
    rows, cols = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                src = idx[
                    max(0, -dx) : n - max(0, dx),
                    max(0, -dy) : n - max(0, dy),
                    max(0, -dz) : n - max(0, dz),
                ]
                dst = idx[
                    max(0, dx) : n - max(0, -dx),
                    max(0, dy) : n - max(0, -dy),
                    max(0, dz) : n - max(0, -dz),
                ]
                rows.append(src.ravel())
                cols.append(dst.ravel())
    return from_coo(np.concatenate(rows), np.concatenate(cols), (n**3, n**3))


def tentative_prolongator(n: int, agg: int = 3):
    """P0: each agg^3 sub-cube aggregates to one coarse point."""
    if n % agg:
        raise ValueError(f"n={n} not divisible by agg={agg}")
    nc = n // agg
    fine = np.arange(n**3)
    x, y, z = np.unravel_index(fine, (n, n, n))
    coarse = (x // agg) * nc * nc + (y // agg) * nc + (z // agg)
    return from_coo(fine, coarse, (n**3, nc**3))


def smoothed_prolongator(a, p0, degree: int = 1):
    """Structure of (I - w D^-1 A)^degree @ P0 (smoothed aggregation)."""
    cur = p0
    for _ in range(degree):
        cur = canonical((a.astype(np.int8) @ cur.astype(np.int8)) + cur.astype(np.int8))
    return cur


def build(cfg: dict) -> Instance:
    a = stencil27(cfg["n"])
    p = smoothed_prolongator(a, tentative_prolongator(cfg["n"], cfg["aggregate"]),
                             cfg["smoother_degree"])
    pt = canonical(p.T)
    ap = symbolic_product(a, p)
    return Instance(
        structures={"A": a, "P": p, "PT": pt, "AP": ap, "PTAP": symbolic_product(pt, ap)},
        products=[Product("AP", "A", "P"), Product("PTAP", "PT", "AP")],
        base=("A", "P", "PT"),
    )


def values(cfg: dict, inst: Instance, count: int, gen: torch.Generator, device) -> list:
    """``count`` sets of A's and P's values, standard normal fp32, made on
    ``device`` in two calls; P^T's are P's in P^T's order."""
    s = inst.structures
    a = torch.randn((count, s["A"].nnz), generator=gen, device=device)
    p = torch.randn((count, s["P"].nnz), generator=gen, device=device)
    perm = torch.as_tensor(transpose_order(s["P"]), device=device)
    pt = p[:, perm]
    return [{"A": a[i], "P": p[i], "PT": pt[i]} for i in range(count)]
