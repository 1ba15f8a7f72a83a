"""One front door: ``repro_torch.plan(A, B, p=4)`` — partition to product, on
the card.

The PyTorch counterpart of ``repro.api``: the same pipeline over the
declarative ``ModelSpec`` registry, with planning copied (numpy/scipy,
bit-for-bit the reference's results) and execution in PyTorch and CUDA:

    import repro_torch

    spgemm = repro_torch.plan(A, B, p=4, model="auto", eps=0.10, seed=0)
    spgemm.cost_report()             # predicted / planned / padded words
    exe = spgemm.compile()           # on the card; device="cpu" for the CPU
    C = exe(a_vals, b_vals)          # dense C tensor on the card, == A @ B

``A`` / ``B`` are structures (dense array, scipy sparse, or
``SparseStructure``); values are 1-D nonzero vectors in canonical CSR order
for every model — the registry's ``pack_values`` hides monoC's block layout.
``model`` is any of the paper's seven (``repro_torch.MODELS``), the
partition-free Sparse SUMMA baseline ``"summa2d"``, or ``"auto"``:
partition every executable model and keep the communication-minimal one
(the reference's rule: fewest predicted words among the plans that lower;
summa2d is never auto-selected).  ``engine="device"`` runs the partitioner's
V-cycle on the card (``core/partition.py``).

``compile(batch=n)`` streams batches of same-structure values through one
executor per capacity bucket, and ``session(...)`` is the long-lived handle
for loops whose structure drifts (``distributed/session.py``).
``compile(group=g)`` runs this process's rank of a ``torch.distributed``
process group of p processes (``launch.ranks.run_ranks`` starts them): each
process holds its own rank's tables, and the handle still returns the
whole dense C on every rank.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.comm import (
    CommCosts,
    evaluate,
    memory_dependent_bound,
    memory_independent_bound,
)
from repro_torch.core.hypergraph import Hypergraph
from repro_torch.core.partition import PartitionResult, partition as _partition
from repro_torch.core.spgemm_models import SpGEMMInstance
from repro_torch.distributed.plan_ir import (
    ExecutionPlan,
    build_volume_plan,
    measured_route_words,
    route_messages,
)
from repro_torch.distributed.registry import ModelSpec, executable_models, get_spec

__all__ = ["CompiledSpGEMM", "PlannedSpGEMM", "device_count", "plan", "session"]


def device_count() -> int:
    """CUDA devices visible to this process (the reference counts jax's
    devices; the port's executors run on CUDA devices)."""
    return torch.cuda.device_count()


# ---------------------------------------------------------------------------
# the compiled handle
# ---------------------------------------------------------------------------
class CompiledSpGEMM:
    """A compiled SpGEMM pipeline: canonical values in, dense C out.

    Wraps the runtime's executor with the model's value packing and
    unpacking, so the caller passes 1-D nonzero value vectors (canonical
    CSR order of the planned structures, as tensors or numpy arrays) and
    gets the dense (I, J) product as a tensor on the handle's device.  The
    raw rank-major interface stays available as ``.runtime``.

    A handle compiled with ``batch=n`` streams value *batches*: inputs are
    (m, nnz) stacks with ``1 <= m <= batch_capacity`` (the bucketed
    capacity), the output is (m, I, J).  Ragged batches are zero-padded up
    to the capacity on the way in and trimmed on the way out, so every
    batch size within one bucket runs the same executor.
    """

    def __init__(self, planned: "PlannedSpGEMM", runtime_exe, spec: ModelSpec):
        self.planned = planned
        self.runtime = runtime_exe
        self.spec = spec
        I, _, J = planned.instance.shape
        self._out = (I, J)

    @property
    def device(self) -> torch.device:
        return self.runtime.device

    @property
    def dtype(self) -> torch.dtype:
        return self.runtime.dtype

    @property
    def batch_capacity(self) -> int | None:
        """Batch slots the executor was built for (None: unbatched)."""
        return self.runtime.batch

    @property
    def cost_model_words(self) -> tuple[int, int]:
        """(ideal, padded) words per call, from the plan's routes."""
        return self.runtime.cost_model_words

    def pack(self, a_values, b_values) -> tuple[torch.Tensor, torch.Tensor]:
        """Canonical 1-D nonzero vectors -> the executor's value layout.

        For a batched handle the inputs are (m, nnz) stacks, packed as one
        and zero-padded to the compiled batch capacity (padding rows cost
        device work, never correctness — their products are dropped by
        ``__call__``).
        """
        block = self.runtime.block
        if self.batch_capacity is None:
            return (
                self.spec.pack_values(torch.as_tensor(a_values), block),
                self.spec.pack_values(torch.as_tensor(b_values), block),
            )
        cap = self.batch_capacity

        def pack_stack(values, name):
            values = torch.atleast_2d(torch.as_tensor(values))
            m = values.shape[0]
            if not 1 <= m <= cap:
                raise ValueError(
                    f"{name} batch of {m} exceeds the compiled capacity {cap}; "
                    f"recompile with batch={m} (bucketed) or split the batch"
                )
            packed = self.spec.pack_values(values, block)
            if m < cap:
                padded = packed.new_zeros((cap, *packed.shape[1:]))
                padded[:m] = packed
                packed = padded
            return packed, m

        a, m_a = pack_stack(a_values, "A")
        b, m_b = pack_stack(b_values, "B")
        if m_a != m_b:
            raise ValueError(f"A batch ({m_a}) and B batch ({m_b}) disagree")
        return a, b

    def prepare(self, a_values, b_values) -> tuple:
        """The local half of a call (``runtime.CompiledSpGEMM.prepare``):
        the values packed into the executor's tables, and the batch's size
        (None unbatched).  ``run`` finishes it."""
        with tracing.span("api.prepare"):
            a, b = self.pack(a_values, b_values)
            m = None
            if self.batch_capacity is not None:
                m = torch.atleast_2d(torch.as_tensor(a_values)).shape[0]
            return self.runtime.prepare(a, b), m

    def run(self, prepared: tuple) -> torch.Tensor:
        """The collective half of a call: the step and the unpacking, the
        dense C ((m, I, J) for a batch of m)."""
        tables, m = prepared
        I, J = self._out
        if m is None:
            return self.runtime.unpack(self.runtime.run(tables))[:I, :J]
        return self.runtime.unpack(self.runtime.run(tables)[:m])[:, :I, :J]

    def __call__(self, a_values, b_values) -> torch.Tensor:
        return self.run(self.prepare(a_values, b_values))


# ---------------------------------------------------------------------------
# the planned handle
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)  # identity semantics: fields hold ndarrays
class PlannedSpGEMM:
    """One partition-is-the-algorithm pipeline, planned and ready.

    Owns the instance, the model hypergraph, the ``PartitionResult`` and
    the lowered ``ExecutionPlan`` (None when an include_nz partition does
    not lower).  ``compile()`` builds the executor on a device;
    ``execute``/``__call__`` go straight from canonical nonzero values to
    the dense product.
    """

    instance: SpGEMMInstance
    model: str
    # None on a handle restored from the plan store, and for partition-free
    # baselines (summa2d): no hypergraph was built
    hypergraph: Hypergraph | None
    partition: PartitionResult | None  # None for partition-free baselines
    execution_plan: ExecutionPlan | None
    eps: float = 0.10
    seed: int = 0
    selection: list[dict] | None = None  # model="auto" sweep records

    @property
    def spec(self) -> ModelSpec:
        return get_spec(self.model)

    @property
    def p(self) -> int:
        if self.partition is not None:
            return self.partition.p
        return self.execution_plan.p

    @property
    def executable(self) -> bool:
        return self.execution_plan is not None

    def costs(self) -> CommCosts:
        """The partition's communication metrics (Lemma 4.2 machinery)."""
        if self.partition is None:
            raise ValueError(
                f"model {self.model!r} is partition-free (no hypergraph); "
                f"its communication is the analytic cost_report()"
            )
        if self.hypergraph is None:
            raise ValueError(
                "this handle was restored from the plan store without its "
                "hypergraph; replan for cost analysis"
            )
        return evaluate(self.hypergraph, self.partition.parts, self.p)

    def cost_report(self) -> dict:
        """Predicted vs planned vs padded words, plus the eq. (1) bounds —
        the same report as ``repro.api.PlannedSpGEMM.cost_report``.

        - ``predicted_words``: the connectivity metric the partitioner
          minimized (sum over cut nets of c(n) * (lambda(n) - 1));
        - ``planned_words``: the words the lowered plan's routing tables
          actually schedule (transfer enumeration — an independent code
          path), item-weighted per the model's convention;
        - ``planned_items``: for models whose items carry several words
          (rowwise's B rows, columnwise's A columns), the items shipped;
        - ``padded_words``: what the padded all_to_all slots move;
        - ``planned_messages``: non-empty (src, dst) route cells;
        - ``bounds``: the classical eq. (1) lower bounds (local memory taken
          as 3 * nnz / p).

        For a partition-free baseline (summa2d) ``predicted_words`` is the
        closed-form analytic volume (``stats["words_analytic"]``) and
        ``planned_words`` the route-table count.
        """
        inst, p = self.instance, self.p
        n_nz = inst.a.nnz + inst.b.nnz + inst.c.nnz
        local_mem = max(3 * n_nz / p, 64)
        report = {
            "model": self.model,
            "p": p,
            "executable": self.executable,
            "bounds": {
                "memory_dependent": round(
                    memory_dependent_bound(inst.n_mult, p, local_mem), 1
                ),
                "memory_independent": round(
                    memory_independent_bound(inst.n_mult, n_nz, p), 1
                ),
            },
        }
        if self.partition is None:
            plan_obj = self.execution_plan
            report["predicted_words"] = int(plan_obj.stats["words_analytic"])
            report["planned_words"] = measured_route_words(plan_obj)
            report["padded_words"] = plan_obj.comm_words_padded
            report["planned_messages"] = route_messages(plan_obj)
            return report
        costs = self.costs()
        report.update(
            {
                "n_vertices": self.hypergraph.n_vertices,
                "n_pins": self.hypergraph.n_pins,
                "predicted_words": int(costs.connectivity),
                "predicted_max_part": int(costs.max_part_cost),
                "expand_words": int(costs.expand),
                "fold_words": int(costs.fold),
                "comp_imbalance": round(costs.comp_imbalance, 4),
            }
        )
        plan_obj = self.execution_plan
        if plan_obj is None:
            # include_nz partitions the lowerer does not accept still get an
            # IR whose words == prediction
            plan_obj = build_volume_plan(self.hypergraph, self.partition.parts, p)
            report["planned_words"] = plan_obj.comm_words_ideal
        else:
            item_words = self.spec.item_words(inst)
            report["planned_words"] = measured_route_words(plan_obj, item_words)
            if item_words is not None:
                # the unit count: item transfers (e.g. B-row shipments)
                report["planned_items"] = measured_route_words(plan_obj)
        report["padded_words"] = plan_obj.comm_words_padded
        report["planned_messages"] = route_messages(plan_obj)
        return report

    def compile(
        self, device=None, dtype=torch.float32, batch: int | None = None, group=None
    ) -> CompiledSpGEMM:
        """Build the pipeline's executor on ``device``.

        ``device=None`` means the card (CUDA) and raises when there is none;
        ``device="cpu"`` runs the kernels' plain PyTorch versions.  The
        route tables, pair lists and scatter indices are uploaded here, once.

        ``batch=n`` builds the *batched* executor: up to ``n`` same-structure
        multiplies stream through one dispatch (multi-RHS, MCL/AMG iterated
        chains).  ``n`` is rounded up to a geometric capacity bucket
        (``runtime.batch_bucket``) so ragged request batches share one
        executor; the handle pads and trims transparently.

        ``group=g`` (a ``torch.distributed`` process group of ``p``
        processes, each calling ``compile`` with it) builds this process's
        rank of the plan alone (``comm.GroupComm``).  Every rank must hold
        the same plan — have rank 0 plan and hand the plan to the others;
        the ranks compare ``runtime.plan_fingerprint`` with rank 0's and all
        raise on a mismatch.  A group whose size is not ``p`` raises.  With
        ``batch`` too, every rank streams the same value batches and gets
        the whole (m, I, J) C; each collective of a dispatch moves all its
        value sets at once.
        """
        if self.execution_plan is None:
            raise ValueError(
                f"model {self.model!r} was planned with include_nz=True "
                f"but its lowerer does not accept V^nz partitions; "
                f"replan with include_nz=False to execute"
            )
        from repro_torch.distributed.runtime import batch_bucket, compile_spgemm

        if group is not None:
            _check_same_plan(self.execution_plan, group)
        inst = self.instance
        runtime_exe = compile_spgemm(
            self.execution_plan,
            inst.a,
            inst.b,
            device=device,
            dtype=dtype,
            block=1,
            c_structure=inst.c,
            batch=None if batch is None else batch_bucket(batch),
            group=group,
        )
        return CompiledSpGEMM(self, runtime_exe, self.spec)

    def execute(self, a_values, b_values, **compile_kwargs) -> torch.Tensor:
        """Canonical nonzero values in, dense C out (compiles on first use;
        the runtime cache makes repeat calls reuse the executor)."""
        return self.compile(**compile_kwargs)(a_values, b_values)

    __call__ = execute


def _check_same_plan(plan: ExecutionPlan, group) -> None:
    """Every rank of ``group`` holds a plan with rank 0's fingerprint, or all
    of them raise (one all-gather of the fingerprints)."""
    import torch.distributed as dist

    from repro_torch.distributed.runtime import plan_fingerprint

    fingerprints = [None] * dist.get_world_size(group)
    dist.all_gather_object(fingerprints, plan_fingerprint(plan), group=group)
    differ = [r for r, fp in enumerate(fingerprints) if fp != fingerprints[0]]
    if differ:
        raise ValueError(
            f"ranks {differ} of the group hold another plan than rank 0; every "
            f"rank must compile the same plan (have rank 0 plan and send it)"
        )


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------
def _plan_one(
    inst: SpGEMMInstance,
    model: str,
    p: int,
    eps: float,
    seed: int,
    include_nz: bool,
    engine: str,
    warm_start: np.ndarray | None = None,
    warm_drift_limit: float = 0.5,
    coarsen: str = "auto",
    device=None,
) -> PlannedSpGEMM:
    spec = get_spec(model)
    if spec.build is None:
        # partition-free baseline (summa2d): no hypergraph to build or
        # partition — lower the instance straight to its execution plan
        with tracing.span("plan.lower", always=True):
            plan_obj = spec.lower(inst, None, p)
        return PlannedSpGEMM(
            instance=inst,
            model=model,
            hypergraph=None,
            partition=None,
            execution_plan=plan_obj,
            eps=eps,
            seed=seed,
        )
    with tracing.span("plan.build", always=True):
        hg = spec.build(inst, include_nz=include_nz)
    with tracing.span("plan.partition", always=True):
        res = _partition(
            hg,
            p,
            eps=eps,
            seed=seed,
            engine=engine,
            warm_start=warm_start,
            warm_drift_limit=warm_drift_limit,
            coarsen=coarsen,
            device=device,
        )
    # a V^nz partition lowers only where the model's lowerer accepts one
    # (fine); elsewhere the handle stays analysis-only
    plan_obj = None
    if not include_nz or spec.lower_include_nz:
        with tracing.span("plan.lower", always=True):
            plan_obj = spec.lower(inst, res.parts, p)
    return PlannedSpGEMM(
        instance=inst,
        model=model,
        hypergraph=hg,
        partition=res,
        execution_plan=plan_obj,
        eps=eps,
        seed=seed,
    )


def plan(
    A,
    B=None,
    p: int = 8,
    model: str = "auto",
    eps: float = 0.10,
    seed: int = 0,
    name: str = "",
    include_nz: bool = False,
    engine: str = "flat",
    coarsen: str = "auto",
    device=None,
) -> PlannedSpGEMM:
    """Plan a distributed SpGEMM: model the instance, partition, lower.

    ``A`` / ``B`` give the nonzero structures (dense array, scipy sparse
    matrix, or ``SparseStructure`` — values never enter the inspector);
    alternatively ``A`` may be an existing ``SpGEMMInstance`` (``B``
    omitted).  ``model`` is one of the paper's seven (``MODELS``),
    ``"summa2d"`` (the partition-free Sparse SUMMA baseline, never
    auto-selected) or ``"auto"``: partition every ``executable_models()``
    candidate and keep the one with the fewest predicted words, among those
    whose plans lower when any does; the per-model cost reports land on
    ``.selection``.  ``include_nz`` keeps the V^nz nonzero vertices; only
    fine's lowerer accepts such partitions, the other handles stay
    cost-only.  ``engine`` is ``"flat"`` (default), ``"loop"`` or
    ``"device"`` (the partitioner's V-cycle as torch ops on ``device``: the
    card unless ``device="cpu"``; ``coarsen`` picks its descend,
    ``"device"`` on the device, ``"host"`` in scipy, or ``"auto"``: the
    device one where its first level fits the reference's int32 sort-key
    packing, else the host one); the results equal ``repro.plan`` with the
    same arguments, except ``coarsen="auto"`` past that packing bound,
    where the reference stops its descent before the first level.
    """
    if isinstance(A, SpGEMMInstance):
        if B is not None:
            raise ValueError("B must be omitted when A is an SpGEMMInstance")
        inst = A
    else:
        if B is None:
            raise ValueError("B is required unless A is an SpGEMMInstance")
        inst = SpGEMMInstance.from_operands(A, B, name=name)
    if model != "auto":
        return _plan_one(
            inst, model, p, eps, seed, include_nz, engine, coarsen=coarsen, device=device
        )
    candidates = [
        _plan_one(inst, m, p, eps, seed, include_nz, engine, coarsen=coarsen, device=device)
        for m in executable_models()
    ]
    records = []
    for cand in candidates:
        rec = cand.cost_report()
        rec["selected"] = False
        records.append(rec)
    viable = [i for i, c in enumerate(candidates) if c.execution_plan is not None]
    pool = viable or range(len(candidates))
    best = min(pool, key=lambda i: records[i]["predicted_words"])
    records[best]["selected"] = True
    chosen = candidates[best]
    chosen.selection = records
    return chosen


def session(
    p: int = 8,
    model: str = "auto",
    eps: float = 0.10,
    seed: int = 0,
    engine: str = "flat",
    store_dir: str | None = None,
    policy=None,
    **kwargs,
):
    """A resilient handle for iterated, structure-drifting SpGEMM.

    ``repro_torch.session(p=4)`` returns a ``SpGEMMSession``: call it like
    ``plan(...)`` would be called per structure, but across a loop —
    ``sess.multiply(A, B)`` fingerprints the operands, reuses the warm
    executor when the structure is unchanged, warm-start-replans on drift,
    persists plans under ``store_dir`` (a restarted session rebuilds its
    pool from there), and retries/downgrades through ``policy`` (a
    ``resilience.FaultPolicy``) on stage failures.  ``device`` (a keyword,
    default the card) is where its executors run; ``group`` (a keyword, a
    ``torch.distributed`` group of p processes, each making the same
    calls) runs one rank a process.  See
    ``repro_torch.distributed.session`` for the full contract.
    """
    from repro_torch.distributed.session import SpGEMMSession

    return SpGEMMSession(
        p=p,
        model=model,
        eps=eps,
        seed=seed,
        engine=engine,
        store_dir=store_dir,
        policy=policy,
        **kwargs,
    )
