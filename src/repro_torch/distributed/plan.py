"""Inspector phase: lower a hypergraph partition to a static execution plan.

The partition of a model decides ownership; the plan materializes, with
static padded shapes, exactly the data movement the hypergraph cut
prescribes.  The plan containers and the vectorized builders live in
``plan_ir`` (one ``ExecutionPlan`` IR for every model); this module
re-exports them and keeps the original loop-based row-wise inspector as an
executable specification (a copy of ``repro.distributed.plan``); the
tests pin the vectorized builder to it byte for byte, in both packages.
``build_rowwise_plan_loop`` is importable from here; the package-level name
``repro_torch.distributed.build_rowwise_plan_loop`` still resolves, through
a shim that warns once, as the reference's does.

- row-wise: device d owns row set R_d of A and C, and row set S_d of B (the
  partition of V^B, or round-robin when V^nz was omitted).  The expand phase
  sends B row k from its owner to every device whose A-columns touch k — one
  transfer per (cut net, touched part) pair, i.e. volume = sum_n c(n) *
  (lambda(n) - 1) plus padding.  Realized as a single padded all_to_all.
- outer-product: device d owns column set K_d of A and B-row set K_d; the
  fold phase routes partial C rows to C's owner.
- monochrome-C: device d owns a C-nonzero set; two expand phases ship the
  cut A- and B-nets, local compute streams BSR pair lists (see ``plan_ir``).

All index arrays are padded to per-pair maxima so XLA sees static shapes; the
padding fraction is reported so benchmarks can quantify executor overhead vs
the combinatorial volume.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.spgemm_models import SpGEMMInstance
from repro_torch.distributed.plan_ir import (  # noqa: F401  (re-exports)
    ExecutionPlan,
    MonoCPlan,
    OuterPlan,
    Route,
    RowwisePlan,
    build_monoC_plan,
    build_outer_plan,
    build_rowwise_plan,
)

__all__ = [
    "ExecutionPlan",
    "Route",
    "RowwisePlan",
    "OuterPlan",
    "MonoCPlan",
    "build_rowwise_plan",
    "build_outer_plan",
    "build_monoC_plan",
    "build_rowwise_plan_loop",
]


def build_rowwise_plan_loop(
    inst: SpGEMMInstance,
    row_part: np.ndarray,
    p: int,
    b_part: np.ndarray | None = None,
) -> RowwisePlan:
    """Original per-k Python-loop inspector, kept as the executable
    specification of ``plan_ir.build_rowwise_plan`` (which must reproduce
    its routing tables byte for byte)."""
    I, K, J = inst.shape
    row_part = np.asarray(row_part, dtype=np.int64)
    if b_part is None:
        # default B distribution: round-robin rows (paper Sec. 6: V^nz omitted)
        b_part = np.arange(K, dtype=np.int64) % p
    # which devices need B row k: parts of A-column-k's rows
    acsc = inst.a.tocsc()
    need = [[] for _ in range(K)]  # destinations per B row
    for k in range(K):
        rows = acsc.indices[acsc.indptr[k] : acsc.indptr[k + 1]]
        devs = np.unique(row_part[rows])
        need[k] = [int(d) for d in devs]

    send_lists: dict[tuple[int, int], list[int]] = {}
    ideal = 0
    for k in range(K):
        src = int(b_part[k])
        for d in need[k]:
            if d == src:
                continue
            send_lists.setdefault((src, d), []).append(k)
            ideal += 1

    T_max = max((len(v) for v in send_lists.values()), default=0)
    T_max = max(T_max, 1)
    send_idx = np.full((p, p, T_max), -1, dtype=np.int64)
    recv_key = np.full((p, p, T_max), -1, dtype=np.int64)

    # local B-row numbering per device
    owned = [np.flatnonzero(b_part == d) for d in range(p)]
    K_max = max((len(o) for o in owned), default=1)
    K_max = max(K_max, 1)
    local_b_rows = np.full((p, K_max), -1, dtype=np.int64)
    local_of = np.full(K, -1, dtype=np.int64)
    for d in range(p):
        local_b_rows[d, : len(owned[d])] = owned[d]
        local_of[owned[d]] = np.arange(len(owned[d]))

    for (s, d), ks in send_lists.items():
        send_idx[s, d, : len(ks)] = local_of[np.array(ks)]
        recv_key[s, d, : len(ks)] = ks

    rows_by_dev = [np.flatnonzero(row_part == d) for d in range(p)]
    I_max = max((len(r) for r in rows_by_dev), default=1)
    I_max = max(I_max, 1)
    local_rows = np.full((p, I_max), -1, dtype=np.int64)
    for d in range(p):
        local_rows[d, : len(rows_by_dev[d])] = rows_by_dev[d]

    padded = p * p * T_max if ideal else 0
    return RowwisePlan(
        model="rowwise",
        p=p,
        ownership={"a_row": row_part, "b_row": np.asarray(b_part, dtype=np.int64)},
        local_ids={"a_row": local_rows, "b_row": local_b_rows},
        routes={
            "expand": Route(
                payload="B",
                send_idx=send_idx,
                recv_key=recv_key,
                items_ideal=ideal,
                items_padded=padded,
            )
        },
    )
