"""Matrix generators for the paper's three applications (Sec. 6).

- AMG model problem (Sec. 6.1): 27-point stencil A1 on an N^3 grid plus a
  smoothed-aggregation prolongator P (3x3x3 aggregates, damped-Jacobi
  smoothing => structure of (I - w D^-1 A) P0 = structure of P0 + A@P0).
- SA-rhoAMGe-like (Sec. 6.1): ~35x coarsening with a polynomial (degree-2)
  smoother => denser P.
- LP normal equations (Sec. 6.2): staircase/multicommodity-flow-like
  constraint matrices A (I < K), SpGEMM is A @ A^T (D^2 is diagonal, no
  structural effect).
- MCL (Sec. 6.3): squaring adjacency structures — scale-free
  (Barabási–Albert, social/protein-like) and a road-network-like grid.

All generators are structure-only and deterministic given a seed.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from repro_torch.sparse.structure import SparseStructure, from_coo, spgemm_symbolic
from repro_torch.core.spgemm_models import SpGEMMInstance


# ---------------------------------------------------------------------------
# AMG (Sec. 6.1)
# ---------------------------------------------------------------------------
def stencil27(n: int) -> SparseStructure:
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


def tentative_prolongator(n: int, agg: int = 3) -> SparseStructure:
    """P0: each agg^3 sub-cube aggregates to one coarse point."""
    if n % agg:
        raise ValueError(f"n={n} not divisible by agg={agg}")
    nc = n // agg
    fine = np.arange(n**3)
    x, y, z = np.unravel_index(fine, (n, n, n))
    coarse = (x // agg) * nc * nc + (y // agg) * nc + (z // agg)
    return from_coo(fine, coarse, (n**3, nc**3))


def smoothed_prolongator(
    a: SparseStructure, p0: SparseStructure, degree: int = 1
) -> SparseStructure:
    """Structure of (I - w D^-1 A)^degree @ P0 (smoothed aggregation)."""
    cur = p0
    for _ in range(degree):
        cur = SparseStructure.wrap(
            (a.csr.astype(np.int8) @ cur.csr.astype(np.int8)) + cur.csr.astype(np.int8)
        )
    return cur


def amg_instances(n: int, flavor: str = "model") -> tuple[SpGEMMInstance, SpGEMMInstance]:
    """The two SpGEMMs of one Galerkin triple product: A@P and P^T@(AP).

    flavor='model': 27-pt + degree-1 smoothing, 3x3x3 aggregates (27-AP rows
    of Tab. II).  flavor='sa_rho': degree-2 smoothing (denser, SA-rho-like).
    """
    a = stencil27(n)
    if flavor == "model":
        p = smoothed_prolongator(a, tentative_prolongator(n, 3), degree=1)
        tag = "27"
    elif flavor == "sa_rho":
        p = smoothed_prolongator(a, tentative_prolongator(n, 3), degree=2)
        tag = "SA"
    else:
        raise ValueError(flavor)
    ap = spgemm_symbolic(a, p)
    inst1 = SpGEMMInstance(a, p, name=f"{tag}-AP(n={n})")
    inst2 = SpGEMMInstance(p.transpose(), ap, name=f"{tag}-PTAP(n={n})")
    return inst1, inst2


def geometric_row_partition(n: int, p: int) -> np.ndarray:
    """Geometric partition of grid rows into p ~cubical subdomains (the
    'Geometric-row' baseline of Fig. 7).  p need not be a cube; we factor it
    into three near-equal factors."""
    f = _factor3(p)
    bounds = [np.linspace(0, n, fi + 1).astype(int) for fi in f]
    part_of = np.empty(n**3, dtype=np.int64)
    x, y, z = np.unravel_index(np.arange(n**3), (n, n, n))
    px = np.searchsorted(bounds[0], x, side="right") - 1
    py = np.searchsorted(bounds[1], y, side="right") - 1
    pz = np.searchsorted(bounds[2], z, side="right") - 1
    part_of[:] = (px * f[1] + py) * f[2] + pz
    return part_of


def _factor3(p: int) -> tuple[int, int, int]:
    best = (1, 1, p)
    for a in range(1, int(round(p ** (1 / 3))) + 2):
        if p % a:
            continue
        q = p // a
        for b in range(a, int(np.sqrt(q)) + 2):
            if q % b:
                continue
            c = q // b
            if c >= b:
                cand = (a, b, c)
                if max(cand) - min(cand) < max(best) - min(best):
                    best = cand
    return best


# ---------------------------------------------------------------------------
# LP normal equations (Sec. 6.2)
# ---------------------------------------------------------------------------
def lp_constraint_matrix(
    n_rows: int,
    n_cols: int,
    nnz_per_row: float = 7.0,
    n_blocks: int = 8,
    coupling_cols: float = 0.05,
    seed: int = 0,
) -> SparseStructure:
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


def lp_instance(name: str, scale: float = 1.0, seed: int = 0) -> SpGEMMInstance:
    """Named LP instances with Tab. II-like aspect ratios, at reduced size."""
    presets = {
        # name: (I, K, nnz_per_row, blocks)
        "fome21": (6700, 21600, 6.9, 16),
        "pds80": (12900, 43400, 7.2, 24),
        "pds100": (15600, 51400, 7.0, 24),
        "cont11l": (14600, 19600, 3.7, 8),
        "sgpf5y6": (12300, 15600, 3.4, 8),
    }
    I, K, nnz, blocks = presets[name]
    I, K = int(I * scale), int(K * scale)
    a = lp_constraint_matrix(I, K, nnz, blocks, seed=seed)
    return SpGEMMInstance(a, a.transpose(), name=f"LP-{name}")


# ---------------------------------------------------------------------------
# MCL (Sec. 6.3)
# ---------------------------------------------------------------------------
def scale_free_graph(n: int, m: int, seed: int = 0) -> SparseStructure:
    """Barabási–Albert adjacency + identity (self loops), symmetric.

    Reproduces networkx's ``barabasi_albert_graph(n, m, seed=seed)`` edge
    for edge without networkx: a star on nodes 0..m, then each new node
    draws m distinct targets with ``random.Random(seed).choice`` over the
    degree-repeated node list.  The targets go into a ``set``, and the list
    grows by that set's iteration order, as networkx's does; a list, or any
    other order, gives another graph after the first few nodes.
    """
    import random

    if not 1 <= m < n:
        raise ValueError(f"Barabási–Albert needs 1 <= m < n, got m = {m}, n = {n}")
    rng = random.Random(seed)
    src, dst = [0] * m, list(range(1, m + 1))  # the star
    repeated = [0] * m + list(range(1, m + 1))  # each node once per degree
    for source in range(m + 1, n):
        targets = set()
        while len(targets) < m:
            targets.add(rng.choice(repeated))
        src.extend([source] * m)
        dst.extend(targets)
        repeated.extend(targets)
        repeated.extend([source] * m)
    adj = sp.coo_matrix((np.ones(len(src), np.int8), (src, dst)), shape=(n, n)).tocsr()
    adj = adj + adj.T + sp.identity(n, dtype=np.int8, format="csr")
    return SparseStructure.wrap(sp.csr_matrix(adj))


def road_network_graph(n_side: int, seed: int = 0) -> SparseStructure:
    """2D grid graph with a sprinkling of diagonal shortcuts (roadnet-like:
    avg degree ~2.8-4, huge diameter, no hubs)."""
    rng = np.random.default_rng(seed)
    n = n_side * n_side
    idx = np.arange(n).reshape(n_side, n_side)
    rows = [idx[:, :-1].ravel(), idx[:-1, :].ravel()]
    cols = [idx[:, 1:].ravel(), idx[1:, :].ravel()]
    # delete ~30% of edges to thin it out (roads are sparser than grids)
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    keep = rng.random(len(r)) > 0.3
    r, c = r[keep], c[keep]
    all_r = np.concatenate([r, c, np.arange(n)])
    all_c = np.concatenate([c, r, np.arange(n)])
    return from_coo(all_r, all_c, (n, n))


def mcl_instance(name: str, scale: float = 1.0, seed: int = 0) -> SpGEMMInstance:
    """Named MCL instances (Tab. II families) at reduced size: squaring a
    symmetric adjacency structure."""
    presets = {
        # name: (n, BA attachment m)  — chosen to hit Tab. II avg-degree
        "facebook": (4000, 22),
        "dip": (5000, 4),
        "wiphi": (5900, 4),
        "biogrid11": (5800, 11),
        "enron": (9000, 5),
        "dblp": (12000, 2),
    }
    if name == "roadnetca":
        side = int(140 * np.sqrt(scale))
        a = road_network_graph(side, seed=seed)
    else:
        n, m = presets[name]
        a = scale_free_graph(int(n * scale), m, seed=seed)
    return SpGEMMInstance(a, a, name=f"MCL-{name}")
