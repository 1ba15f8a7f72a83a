"""Declarative model registry: one ``ModelSpec`` per ported paper model.

Mirrors ``repro.distributed.registry``.  A ``ModelSpec`` bundles:

- ``build``: the hypergraph builder (Sec. 5 / Def. 3.1, via ``core``);
- ``lower``: partition -> ``ExecutionPlan`` (pin-derived ownership so the
  planned words equal the model's connectivity prediction);
- ``make_runner``: the value-time executor core (value packing + step);
- ``make_unpack`` / ``pack_values``: rank-major shards <-> caller layout;
- ``measured``: how the plan's routed words relate to the model's
  predicted words.

Ranks are stacked in plan order: rank d is row d of every rank-major table,
which is the row-major flattening of the reference's (2, p // 2) mesh, so a
plan's rank d is the same rank in both executors.  Only monoC is ported so
far; every other model of the reference (and ``model="auto"``, which ranges
over them) raises "not yet ported".
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.spgemm_models import MODELS, SpGEMMInstance, build_model
from repro_torch.distributed.plan_ir import (
    ExecutionPlan,
    build_monoC_plan,
    derive_owner_from_pins,
)
from repro_torch.distributed.spgemm_exec import make_monoC_step, make_monoC_unpack


@dataclasses.dataclass(frozen=True)
class RunnerSetup:
    """What the runtime needs to run one executor: ``pack`` scatters 1-D
    value stacks into rank-major owned tables (its indices uploaded once),
    ``step`` runs the plan on those tables, and the value shapes and dense
    shape it was built for."""

    pack: Callable
    step: Callable
    a_shape: tuple[int, ...]
    b_shape: tuple[int, ...]
    out_shape: tuple[int, int]


def owner_slot(local_ids: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Invert a padded per-device id list into global-id -> (device, slot)
    lookup arrays (every id appears exactly once by construction)."""
    dev = np.empty(n, dtype=np.int64)
    slot = np.empty(n, dtype=np.int64)
    d, s = np.nonzero(local_ids >= 0)
    g = local_ids[d, s]
    dev[g] = d
    slot[g] = s
    return dev, slot


# ---------------------------------------------------------------------------
# plan lowerers (partition -> ExecutionPlan, pin-derived ownership)
# ---------------------------------------------------------------------------
def _lower_monoC(inst: SpGEMMInstance, parts: np.ndarray, p: int) -> ExecutionPlan:
    mult_dev = parts[inst.mult_c_pos]
    a_part = derive_owner_from_pins(inst.mult_a_pos, mult_dev, inst.a.nnz, p)
    b_part = derive_owner_from_pins(inst.mult_b_pos, mult_dev, inst.b.nnz, p)
    return build_monoC_plan(inst, parts, p, a_part=a_part, b_part=b_part)


# ---------------------------------------------------------------------------
# runner factories
# ---------------------------------------------------------------------------
def _monoC_runner(plan, a_structure, b_structure, *, device, dtype, block):
    # a_structure / b_structure are the BLOCK structures here; values are
    # (nnz, block, block) stacks in block CSR (= to_bsr) order
    p = plan.p
    I, _ = a_structure.shape
    _, J = b_structure.shape
    nA, nB = a_structure.nnz, b_structure.nnz
    if nA != len(plan.a_part) or nB != len(plan.b_part):
        raise ValueError("plan was built for a different block structure")
    adev, aslot = owner_slot(plan.local_ids["a_nz"], nA)
    bdev, bslot = owner_slot(plan.local_ids["b_nz"], nB)
    N_a = plan.local_ids["a_nz"].shape[1]
    N_b = plan.local_ids["b_nz"].shape[1]
    a_idx = torch.as_tensor(adev * N_a + aslot, device=device)
    b_idx = torch.as_tensor(bdev * N_b + bslot, device=device)
    step = make_monoC_step(plan, device, block=block)

    def pack(a_values, b_values):
        a_own = torch.zeros((p * N_a, block, block), dtype=dtype, device=device)
        b_own = torch.zeros((p * N_b, block, block), dtype=dtype, device=device)
        a_own[a_idx] = a_values
        b_own[b_idx] = b_values
        return (
            a_own.reshape(p, N_a, block, block),
            b_own.reshape(p, N_b, block, block),
        )

    return RunnerSetup(
        pack, step, (nA, block, block), (nB, block, block), (I * block, J * block)
    )


def _values_blocked(vals, block: int):
    return vals.reshape(-1, block, block)


# ---------------------------------------------------------------------------
# the spec and the registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Everything one paper model needs, declared in one place.

    ``measured`` states how the plan's route-counted words relate to the
    model's prediction ("exact": words on the wire == the predicted words).
    """

    name: str
    build: Callable  # (inst, include_nz=False) -> Hypergraph
    lower: Callable  # (inst, parts, p) -> ExecutionPlan
    make_runner: Callable  # (plan, a_s, b_s, *, device, dtype, block) -> RunnerSetup
    make_unpack: Callable  # (plan, c_structure, shape, device) -> unpack fn
    pack_values: Callable  # (vals, block) -> executor layout
    measured: str | None = None


def _build(model: str) -> Callable:
    def build(inst: SpGEMMInstance, include_nz: bool = False):
        return build_model(inst, model, include_nz=include_nz)

    return build


MODEL_SPECS: dict[str, ModelSpec] = {
    "monoC": ModelSpec(
        name="monoC",
        build=_build("monoC"),
        lower=_lower_monoC,
        make_runner=_monoC_runner,
        make_unpack=make_monoC_unpack,
        pack_values=_values_blocked,
        measured="exact",
    ),
}


def get_spec(model: str) -> ModelSpec:
    spec = MODEL_SPECS.get(model)
    if spec is not None:
        return spec
    if model in MODELS or model in ("summa2d", "auto"):
        raise ValueError(
            f"model {model!r} is not yet ported to repro_torch (ported: "
            f"{tuple(MODEL_SPECS)}); ROADMAP.md Queue 1 names its slice"
        )
    raise ValueError(f"unknown model {model!r}; choose from {tuple(MODEL_SPECS)}")
