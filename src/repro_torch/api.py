"""One front door: ``repro_torch.plan(A, B, p=4, model="monoC")`` — partition
to product, on the card.

The PyTorch counterpart of ``repro.api``: the same pipeline over the
declarative ``ModelSpec`` registry, with planning copied (numpy/scipy,
bit-for-bit the reference's results) and execution in PyTorch and CUDA:

    import repro_torch

    spgemm = repro_torch.plan(A, B, p=4, model="monoC", eps=0.10, seed=0)
    spgemm.cost_report()             # predicted / planned / padded words
    exe = spgemm.compile()           # on the card; device="cpu" for the CPU
    C = exe(a_vals, b_vals)          # dense C tensor on the card, == A @ B

``A`` / ``B`` are structures (dense array, scipy sparse, or
``SparseStructure``); values are 1-D nonzero vectors in canonical CSR order.
Only monoC is ported so far: other models and ``model="auto"`` raise.
"""
from __future__ import annotations

import dataclasses

import torch

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
from repro_torch.distributed.registry import ModelSpec, get_spec

__all__ = ["CompiledSpGEMM", "PlannedSpGEMM", "plan"]


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

    def pack(self, a_values, b_values) -> tuple[torch.Tensor, torch.Tensor]:
        """Canonical 1-D nonzero vectors -> the executor's value layout."""
        block = self.runtime.block
        return (
            self.spec.pack_values(torch.as_tensor(a_values), block),
            self.spec.pack_values(torch.as_tensor(b_values), block),
        )

    def __call__(self, a_values, b_values) -> torch.Tensor:
        I, J = self._out
        a, b = self.pack(a_values, b_values)
        return self.runtime.unpack(self.runtime(a, b))[:I, :J]


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
    hypergraph: Hypergraph
    partition: PartitionResult
    execution_plan: ExecutionPlan | None
    eps: float = 0.10
    seed: int = 0

    @property
    def spec(self) -> ModelSpec:
        return get_spec(self.model)

    @property
    def p(self) -> int:
        return self.partition.p

    @property
    def executable(self) -> bool:
        return self.execution_plan is not None

    def costs(self) -> CommCosts:
        """The partition's communication metrics (Lemma 4.2 machinery)."""
        return evaluate(self.hypergraph, self.partition.parts, self.p)

    def cost_report(self) -> dict:
        """Predicted vs planned vs padded words, plus the eq. (1) bounds —
        the same report as ``repro.api.PlannedSpGEMM.cost_report``.

        - ``predicted_words``: the connectivity metric the partitioner
          minimized (sum over cut nets of c(n) * (lambda(n) - 1));
        - ``planned_words``: the words the lowered plan's routing tables
          actually schedule (transfer enumeration — an independent code
          path), item-weighted per the model's convention;
        - ``padded_words``: what the padded all_to_all slots move;
        - ``planned_messages``: non-empty (src, dst) route cells;
        - ``bounds``: the classical eq. (1) lower bounds (local memory taken
          as 3 * nnz / p).
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
            report["planned_words"] = measured_route_words(plan_obj)
        report["padded_words"] = plan_obj.comm_words_padded
        report["planned_messages"] = route_messages(plan_obj)
        return report

    def compile(self, device=None, dtype=torch.float32) -> CompiledSpGEMM:
        """Build the pipeline's executor on ``device``.

        ``device=None`` means the card (CUDA) and raises when there is none;
        ``device="cpu"`` runs the kernels' plain PyTorch versions.  The
        route tables, pair lists and scatter indices are uploaded here, once.
        """
        if self.execution_plan is None:
            raise ValueError(
                f"model {self.model!r} was planned with include_nz=True "
                f"but its lowerer does not accept V^nz partitions; "
                f"replan with include_nz=False to execute"
            )
        from repro_torch.distributed.runtime import compile_spgemm

        inst = self.instance
        runtime_exe = compile_spgemm(
            self.execution_plan,
            inst.a,
            inst.b,
            device=device,
            dtype=dtype,
            block=1,
            c_structure=inst.c,
        )
        return CompiledSpGEMM(self, runtime_exe, self.spec)

    def execute(self, a_values, b_values, **compile_kwargs) -> torch.Tensor:
        """Canonical nonzero values in, dense C out (compiles on first use;
        the runtime cache makes repeat calls reuse the executor)."""
        return self.compile(**compile_kwargs)(a_values, b_values)

    __call__ = execute


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------
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
) -> PlannedSpGEMM:
    """Plan a distributed SpGEMM: model the instance, partition, lower.

    ``A`` / ``B`` give the nonzero structures (dense array, scipy sparse
    matrix, or ``SparseStructure`` — values never enter the inspector);
    alternatively ``A`` may be an existing ``SpGEMMInstance`` (``B``
    omitted).  ``model`` must be a ported model (``"monoC"``); the
    reference's other models and ``"auto"`` raise until their slices land.
    ``engine`` is ``"flat"`` (default) or ``"loop"``; the results equal
    ``repro.plan`` with the same arguments.
    """
    spec = get_spec(model)
    if isinstance(A, SpGEMMInstance):
        if B is not None:
            raise ValueError("B must be omitted when A is an SpGEMMInstance")
        inst = A
    else:
        if B is None:
            raise ValueError("B is required unless A is an SpGEMMInstance")
        inst = SpGEMMInstance.from_operands(A, B, name=name)
    hg = spec.build(inst, include_nz=include_nz)
    res = _partition(hg, p, eps=eps, seed=seed, engine=engine)
    # monoC's lowerer takes no V^nz partition: such plans stay analysis-only
    plan_obj = None if include_nz else spec.lower(inst, res.parts, p)
    return PlannedSpGEMM(
        instance=inst,
        model=model,
        hypergraph=hg,
        partition=res,
        execution_plan=plan_obj,
        eps=eps,
        seed=seed,
    )
