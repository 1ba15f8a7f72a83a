"""Sparse SUMMA: the sparsity-*oblivious* 2D baseline the paper beats.

The port of ``repro.distributed.summa``: the planning is a numpy copy (the
plan equals the reference's array for array), and the executor runs the
ranks of the ``(pr, pc)`` grid its collective holds: all of them stacked on
one device (``comm.Loopback``) or one a process (``comm.GroupComm``).

The seven hypergraph models ship exactly the cut-net traffic of a partition
tuned to the instance's sparsity.  The classic competitor — Sparse SUMMA
(Buluc & Gilbert, arXiv 1109.3739 / 1006.2183) — fixes the data
distribution up front and broadcasts whole sparse panels regardless of who
actually needs them:

- ranks form a ``(pr, pc)`` grid, flattened row-major (``d = r * pc + c``);
- A, B and C are distributed element-cyclically: ``A(i, k)`` lives on
  ``(i % pr, k % pc)``, ``B(k, j)`` on ``(k % pr, j % pc)``, ``C(i, j)``
  stays put on ``(i % pr, j % pc)`` (stationary C);
- the multiply runs in ``n_stages = lcm(pr, pc)`` stages: stage ``t``
  broadcasts every A nonzero with ``k % n_stages == t`` along its grid
  *row* (``pc - 1`` copies) and every such B nonzero along its grid
  *column* (``pr - 1`` copies), then each rank multiplies the panel pair
  into its owned C slots through the BSR kernel (K1).

Because the broadcast is oblivious, the communication volume is
closed-form — ``nnz(A) * (pc - 1) + nnz(B) * (pr - 1)`` words — and the
per-stage ``Route`` tables enumerate exactly those transfers, so
``measured_route_words(plan) == summa_words_ideal(...)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.spgemm_models import SpGEMMInstance
from repro_torch.distributed.comm import make_comm
from repro_torch.distributed.plan_ir import (
    ExecutionPlan,
    _table_slots,
    build_route,
    padded_id_lists,
)
from repro_torch.distributed.spgemm_exec import _expand, _int32, _send_route, per_set
from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local, pair_runs


class SummaPlan(ExecutionPlan):
    """Stationary-C Sparse SUMMA plan over a ``(pr, pc)`` rank grid.

    Routes ``bcast_a_s{t}`` / ``bcast_b_s{t}`` hold the stage-``t`` panel
    broadcasts; ``pair_*_s{t}`` are the stage-``t`` BSR pair lists in the
    monoC slot-table convention (``[owned | received | zero]`` operand
    tables, owned-C slots plus one trailing garbage slot).
    """

    @property
    def pr(self) -> int:
        return int(self.stats["pr"])

    @property
    def pc(self) -> int:
        return int(self.stats["pc"])

    @property
    def n_stages(self) -> int:
        return int(self.stats["n_stages"])

    @property
    def a_part(self) -> np.ndarray:
        return self.ownership["a_nz"]

    @property
    def b_part(self) -> np.ndarray:
        return self.ownership["b_nz"]

    @property
    def c_part(self) -> np.ndarray:
        return self.ownership["c_nz"]

    @property
    def n_c_slots(self) -> int:
        """Local C slots incl. the trailing garbage slot padding pairs hit."""
        return self.local_ids["c_nz"].shape[1] + 1


def summa_words_ideal(
    inst: SpGEMMInstance, pr: int, pc: int, word_size: int = 1
) -> int:
    """Closed-form SUMMA volume: every A nonzero is broadcast to the other
    ``pc - 1`` columns of its grid row, every B nonzero to the other
    ``pr - 1`` rows of its grid column — sparsity of the *other* operand
    never enters."""
    return int((inst.a.nnz * (pc - 1) + inst.b.nnz * (pr - 1)) * word_size)


def summa_mesh_shape(p: int, inst: SpGEMMInstance | None = None) -> tuple[int, int]:
    """Pick the ``(pr, pc)`` factorization of ``p`` for an instance.

    With an instance in hand the aspect is chosen to minimize the analytic
    volume ``nnz(A) * (pc - 1) + nnz(B) * (pr - 1)``; without one,
    nearest-square.  Ties break toward square, then toward more rows.
    """
    best = None
    for pr in range(1, p + 1):
        if p % pr:
            continue
        pc = p // pr
        vol = 0 if inst is None else summa_words_ideal(inst, pr, pc)
        key = (vol, abs(pr - pc), pc)
        if best is None or key < best[0]:
            best = (key, (pr, pc))
    return best[1]


def build_summa_plan(
    inst: SpGEMMInstance,
    p: int,
    pr: int | None = None,
    pc: int | None = None,
    word_size: int = 1,
) -> SummaPlan:
    """Lower an instance straight to a Sparse SUMMA plan (no partition).

    ``pr``/``pc`` default to ``summa_mesh_shape(p, inst)``.  The stage count
    is ``lcm(pr, pc)`` so the element-cyclic owner maps stay pure 2D cyclic
    (``t(k) % pc == k % pc`` and ``t(k) % pr == k % pr``).
    """
    if pr is None or pc is None:
        pr, pc = summa_mesh_shape(p, inst)
    if pr * pc != p:
        raise ValueError(f"(pr, pc) = ({pr}, {pc}) does not factor p = {p}")
    S = math.lcm(pr, pc)
    nA, nB = inst.a.nnz, inst.b.nnz
    ar, ak = inst.a.coo()
    bk, bj = inst.b.coo()
    cr, cj = inst.c.coo()

    a_part = (ar % pr) * pc + ak % pc
    b_part = (bk % pr) * pc + bj % pc
    c_part = (cr % pr) * pc + cj % pc
    local_a, local_of_a = padded_id_lists(a_part, p)
    local_b, local_of_b = padded_id_lists(b_part, p)
    local_c, local_of_c = padded_id_lists(c_part, p)
    A_max, B_max, C_max = local_a.shape[1], local_b.shape[1], local_c.shape[1]

    def _broadcast_route(ids, owner_rc, along_cols, payload):
        """Oblivious broadcast of the stage panel: each item goes from its
        owner to the other ``w - 1`` positions of its grid row (A) or
        column (B).  Item-major by construction (ids ascend)."""
        rr, cc = owner_rc
        w = pc if along_cols else pr
        lane = np.broadcast_to(np.arange(w, dtype=np.int64), (len(ids), w))
        keep = lane != (cc if along_cols else rr)[:, None]
        if along_cols:
            dst = ((rr[:, None] * pc) + lane)[keep]
        else:
            dst = ((lane * pc) + cc[:, None])[keep]
        src = np.repeat(rr * pc + cc, w - 1)
        item = np.repeat(ids, w - 1)
        local_of = local_of_a if payload == "A" else local_of_b
        return build_route(src, dst, item, local_of, p, payload, word_size)

    a_stage = ak % S
    b_stage = bk % S
    mult_stage = inst.mult_k % S
    mult_dev = (inst.mult_i % pr) * pc + inst.mult_j % pc
    a_pos, b_pos, c_pos = inst.mult_a_pos, inst.mult_b_pos, inst.mult_c_pos

    routes, compute = {}, {}
    n_pairs = 0
    for t in range(S):
        ids_a = np.nonzero(a_stage == t)[0]
        route_a = _broadcast_route(ids_a, (ar[ids_a] % pr, ak[ids_a] % pc), True, "A")
        ids_b = np.nonzero(b_stage == t)[0]
        route_b = _broadcast_route(ids_b, (bk[ids_b] % pr, bj[ids_b] % pc), False, "B")
        routes[f"bcast_a_s{t}"] = route_a
        routes[f"bcast_b_s{t}"] = route_b

        # stage-t pair lists: every multiplication whose k falls in this
        # panel runs on the (stationary) owner of its C nonzero, reading the
        # [owned | received | zero] tables the stage broadcasts filled
        a_slots = _table_slots(a_part, local_of_a, route_a, nA, p)
        b_slots = _table_slots(b_part, local_of_b, route_b, nB, p)
        sel = np.nonzero(mult_stage == t)[0]
        dev = mult_dev[sel]
        pa = a_slots[dev, a_pos[sel]]
        pb = b_slots[dev, b_pos[sel]]
        pcs = local_of_c[c_pos[sel]]
        assert (pa >= 0).all() and (pb >= 0).all(), (
            "SUMMA broadcast missed a needed nonzero"
        )
        order = np.lexsort((pb, pa, pcs, dev))
        pa, pb, pcs, dev = pa[order], pb[order], pcs[order], dev[order]
        counts = np.bincount(dev, minlength=p)
        P_max = max(int(counts.max(initial=0)), 1)
        starts = np.cumsum(counts) - counts
        rank = np.arange(len(dev), dtype=np.int64) - np.repeat(starts, counts)
        pair_a = np.full((p, P_max), A_max + p * route_a.T, dtype=np.int64)
        pair_b = np.full((p, P_max), B_max + p * route_b.T, dtype=np.int64)
        pair_c = np.full((p, P_max), C_max, dtype=np.int64)
        pair_a[dev, rank] = pa
        pair_b[dev, rank] = pb
        pair_c[dev, rank] = pcs
        compute[f"pair_a_s{t}"] = pair_a
        compute[f"pair_b_s{t}"] = pair_b
        compute[f"pair_c_s{t}"] = pair_c
        n_pairs += int(len(dev))

    plan = SummaPlan(
        model="summa2d",
        p=p,
        ownership={"a_nz": a_part, "b_nz": b_part, "c_nz": c_part},
        local_ids={"a_nz": local_a, "b_nz": local_b, "c_nz": local_c},
        routes=routes,
        compute=compute,
        stats={
            "pr": int(pr),
            "pc": int(pc),
            "n_stages": int(S),
            "n_pairs": n_pairs,
            "words_analytic": summa_words_ideal(inst, pr, pc, word_size),
        },
    )
    assert plan.comm_words_ideal == plan.stats["words_analytic"], (
        "stage routes diverged from the closed-form SUMMA volume"
    )
    assert n_pairs == inst.n_mult, "stage pair lists dropped a multiplication"
    return plan


def _lower_summa(inst: SpGEMMInstance, parts, p: int) -> SummaPlan:
    """Registry lowerer: SUMMA is partition-free, ``parts`` is ignored
    (``None`` from the front door — there is no hypergraph to partition)."""
    return build_summa_plan(inst, p)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------
class SummaStep:
    """The Sparse SUMMA executor core for one plan on one device.

    ``step(a_own, b_own)`` takes rank-major packed block tables of the held
    ranks ((held, N_max, b, b)) and returns their rank-major C block slots
    (held, C_max + 1, b, b), monoC's layout.  The ``n_stages`` stages run
    in the reference's order; each expands the owned A and B tables through
    its two broadcast routes (one all_to_all each, as ``MonoCStep`` expands)
    and then launches K1 once over the held ranks' pairs of that stage —
    the i-th held rank's table slots offset by i times that stage's
    per-rank table size, the padding pairs dropped — and adds the stage's
    product into C.

    With ``batch=m`` tables and result have a leading axis of m value sets,
    and each stage's one launch runs m copies of its pair lists, the copy of
    set i offset by i times the p ranks' tables (as ``MonoCStep``).
    """

    def __init__(self, plan: SummaPlan, block: int, device, batch: int | None = None,
                 comm=None):
        p = plan.p
        self.p, self.block, self.device = p, block, torch.device(device)
        self.batch = batch
        self._lead = () if batch is None else (batch,)
        self.comm = make_comm(p, batch) if comm is None else comm
        held = list(self.comm.ranks)
        self.n_held = h = len(held)
        self.n_c_slots = plan.n_c_slots
        m = batch or 1
        self.n_c_blocks = m * h * self.n_c_slots
        rank = np.arange(h, dtype=np.int64)[:, None]
        n_own = {op: plan.local_ids[f"{op}_nz"].shape[1] for op in ("a", "b")}
        self._stages = []
        for t in range(plan.n_stages):
            routes = {op: plan.routes[f"bcast_{op}_s{t}"] for op in ("a", "b")}
            # [owned | received | zero] slots a rank's stage-t table has
            table = {op: n_own[op] + p * routes[op].T + 1 for op in ("a", "b")}
            slots = [h * table["a"], h * table["b"], h * self.n_c_slots]
            if m * max(slots) > np.iinfo(np.int32).max:
                raise ValueError(
                    f"a batch of {m} puts {m} x {max(slots)} table slots past the "
                    f"kernel's int32 indices; split the batch"
                )
            pc_local = plan.compute[f"pair_c_s{t}"][held]
            keep = (pc_local != self.n_c_slots - 1).ravel()
            pa = (plan.compute[f"pair_a_s{t}"][held] + rank * table["a"]).ravel()[keep]
            pb = (plan.compute[f"pair_b_s{t}"][held] + rank * table["b"]).ravel()[keep]
            pc = (pc_local + rank * self.n_c_slots).ravel()[keep]
            pa, pb, pc = (per_set(x, n, batch) for x, n in zip((pa, pb, pc), slots))
            run_start, run_c = pair_runs(pc)
            self._stages.append((
                tuple(
                    _send_route(routes[op], n_own[op], self.device, batch, held)
                    for op in ("a", "b")
                ),
                *(_int32(x, self.device) for x in (pa, pb, pc, run_start, run_c)),
            ))

    @property
    def n_stages(self) -> int:
        return len(self._stages)

    def kernel_inputs(self, a_own: torch.Tensor, b_own: torch.Tensor, t: int) -> tuple:
        """The arguments of stage ``t``'s one ``bsr_spgemm_local`` launch
        (expanding the tables moves that stage's broadcasts)."""
        (route_a, route_b), pa, pb, pc, run_start, run_c = self._stages[t]
        return (
            _expand(self.comm, a_own, route_a, self._lead),
            _expand(self.comm, b_own, route_b, self._lead),
            pa,
            pb,
            pc,
            run_start,
            run_c,
            self.n_c_blocks,
        )

    def __call__(self, a_own: torch.Tensor, b_own: torch.Tensor) -> torch.Tensor:
        c = None
        for t in range(self.n_stages):
            stage = bsr_spgemm_local(*self.kernel_inputs(a_own, b_own, t))
            c = stage if c is None else c.add_(stage)
        return c.reshape(*self._lead, self.n_held, self.n_c_slots, self.block, self.block)


def make_summa_step(
    plan: SummaPlan, device, block: int = 1, batch: int | None = None, comm=None
) -> SummaStep:
    """The SUMMA executor core (``repro``'s ``make_summa_step``), with the
    held ranks' tables uploaded to ``device`` once."""
    return SummaStep(plan, block, device, batch, comm)


def _summa_runner(plan, a_structure, b_structure, *, device, dtype, block, batch=None,
                  group=None):
    """Registry runner factory (monoC's value layout: ``(nnz, b, b)`` blocks
    scattered into rank-major owned tables)."""
    from repro_torch.distributed.registry import _owned_pack, _setup

    I, _ = a_structure.shape
    _, J = b_structure.shape
    nA, nB = a_structure.nnz, b_structure.nnz
    comm = make_comm(plan.p, batch, group)
    pack = _owned_pack(plan, nA, nB, (block, block), dtype, device, batch, comm.ranks)
    step = make_summa_step(plan, device, block=block, batch=batch, comm=comm)
    return _setup(
        pack, step, (nA, block, block), (nB, block, block), (I * block, J * block), batch
    )
