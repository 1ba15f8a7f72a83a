"""Declarative model registry: one ``ModelSpec`` per ported paper model.

Mirrors ``repro.distributed.registry``.  A ``ModelSpec`` bundles:

- ``build``: the hypergraph builder (Sec. 5 / Def. 3.1, via ``core``);
- ``lower``: partition -> ``ExecutionPlan`` (pin-derived ownership so the
  planned words equal the model's connectivity prediction);
- ``make_runner``: the value-time executor core (value packing + step);
  with ``batch=m``, m value sets a dispatch (the reference lifts its step
  with ``jax.vmap``; here each step takes a leading set axis of its own);
- ``make_unpack`` / ``pack_values``: rank-major shards <-> caller layout;
- ``item_words`` / ``measured``: how the plan's routed words relate to the
  model's predicted words.

All seven paper models are executable; columnwise rides the rowwise
machinery under ``C^T = B^T A^T``, and monoA/monoB lower through the fine
plan with multiplications colocated with their stationary operand.  The
Sparse SUMMA baseline (``"summa2d"``, ``distributed/summa.py``) is
partition-free (``build=None``) and executable, but never auto-selected.
Ranks are stacked in plan order: rank d is row d of every rank-major table,
which is the row-major flattening of the reference's meshes, so a plan's
rank d is the same rank in both executors.  A runner factory given a
process ``group`` (``comm.GroupComm``) builds the tables of this process's
rank alone: its pack scatters the full value vectors into that rank's row
only, and its step holds only that rank's routes and pair lists.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.spgemm_models import MODELS, SpGEMMInstance, build_model
from repro_torch.distributed import spgemm_exec as _exec
from repro_torch.distributed.comm import make_comm
from repro_torch.distributed.plan_ir import (
    ExecutionPlan,
    build_fine_plan,
    build_monoC_plan,
    build_outer_plan,
    build_rowwise_plan,
    derive_owner_from_pins,
)
from repro_torch.distributed.summa import _lower_summa, _summa_runner


@dataclasses.dataclass(frozen=True)
class RunnerSetup:
    """What the runtime needs to run one executor: ``pack`` scatters 1-D
    value stacks into rank-major owned tables (its indices uploaded once),
    ``step`` runs the plan on those tables, and the value shapes and dense
    shape it was built for (the value shapes lead with the batch capacity
    for a batched runner)."""

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
def _lower_rowwise(inst: SpGEMMInstance, parts: np.ndarray, p: int) -> ExecutionPlan:
    I, K, _ = inst.shape
    acsc = inst.a_csc
    ks = np.repeat(np.arange(K, dtype=np.int64), np.diff(acsc.indptr))
    b_part = derive_owner_from_pins(ks, parts[acsc.indices.astype(np.int64)], K, p)
    return build_rowwise_plan(inst, parts, p, b_part=b_part)


def _lower_outer(inst: SpGEMMInstance, parts: np.ndarray, p: int) -> ExecutionPlan:
    return build_outer_plan(inst, parts, p)


def _lower_monoC(inst: SpGEMMInstance, parts: np.ndarray, p: int) -> ExecutionPlan:
    mult_dev = parts[inst.mult_c_pos]
    a_part = derive_owner_from_pins(inst.mult_a_pos, mult_dev, inst.a.nnz, p)
    b_part = derive_owner_from_pins(inst.mult_b_pos, mult_dev, inst.b.nnz, p)
    return build_monoC_plan(inst, parts, p, a_part=a_part, b_part=b_part)


def _lower_fine(inst: SpGEMMInstance, parts: np.ndarray, p: int) -> ExecutionPlan:
    return build_fine_plan(inst, parts, p)


def _transposed_instance(inst: SpGEMMInstance) -> SpGEMMInstance:
    """The ``C^T = B^T A^T`` instance: columnwise of ``inst`` IS rowwise of
    this (identical hypergraph — vertex ``v_j`` keeps its index, net
    ``n^A_k`` keeps its pins and its ``nnz(A col k)`` cost)."""
    return SpGEMMInstance(
        inst.b.transpose(), inst.a.transpose(), name=f"{inst.name}^T"
    )


def _lower_columnwise(inst: SpGEMMInstance, parts: np.ndarray, p: int) -> ExecutionPlan:
    plan = _lower_rowwise(_transposed_instance(inst), parts, p)
    plan.model = "columnwise"
    return plan


def _lower_monoA(inst: SpGEMMInstance, parts: np.ndarray, p: int) -> ExecutionPlan:
    # monoA vertices are A nonzeros; colocating every multiplication with
    # its A nonzero makes expand_a empty, expand_b ship each b_kj to the
    # parts of A-column k (= the pins of B-net n^B_k, so items weighted by
    # the net's nnz(B row k) cost sum to exactly the B-net connectivity)
    # and reduce_c ship lambda - 1 partials per C net — measured == predicted
    parts = np.asarray(parts, dtype=np.int64)
    plan = build_fine_plan(inst, parts[inst.mult_a_pos], p, a_part=parts)
    plan.model = "monoA"
    return plan


def _lower_monoB(inst: SpGEMMInstance, parts: np.ndarray, p: int) -> ExecutionPlan:
    # symmetric to monoA with B stationary (vertices are B nonzeros in CSR
    # order, matching the monoB builder's pin convention)
    parts = np.asarray(parts, dtype=np.int64)
    plan = build_fine_plan(inst, parts[inst.mult_b_pos], p, b_part=parts)
    plan.model = "monoB"
    return plan


# ---------------------------------------------------------------------------
# runner factories (``batch=None``: one value set a call; ``batch=m``: m)
# ---------------------------------------------------------------------------
def _setup(pack, step, a_shape, b_shape, out_shape, batch) -> RunnerSetup:
    lead = () if batch is None else (batch,)
    return RunnerSetup(pack, step, (*lead, *a_shape), (*lead, *b_shape), out_shape)


def _held_items(coords: tuple, ranks, p: int):
    """The items of the held ``ranks``: ``coords`` are per-item coordinates
    into rank-major tables, the owner rank first.  Returns the items' ids
    (None when every rank is held: all of them) and their coordinates with
    the owner replaced by its position among the held ranks."""
    if len(ranks) == p:
        return None, coords
    pos = np.full(p, -1, dtype=np.int64)
    pos[list(ranks)] = np.arange(len(ranks))
    sel = np.flatnonzero(pos[coords[0]] >= 0)
    return sel, (pos[coords[0][sel]], *(c[sel] for c in coords[1:]))


def _dense_pack(a_coords, b_coords, a_dims, b_dims, dtype, device, item=(), batch=None,
                ranks=None):
    """``pack(a_values, b_values)`` scattering value stacks ((nnz, *item),
    or (batch, nnz, *item)) into zeroed rank-major tables
    (``[batch,] *dims, *item``; the leading dim counts the held ``ranks``,
    every rank when None) at the coordinates ``a_coords`` / ``b_coords``
    (numpy, owner rank first; uploaded once, repeated per value set).  With
    some ranks held, only their items' values are scattered."""
    lead = () if batch is None else (batch,)
    p = a_dims[0]
    ranks = range(p) if ranks is None else ranks
    dims, flat, sel = [], [], []
    for coords, d in ((a_coords, a_dims), (b_coords, b_dims)):
        ids, coords = _held_items(coords, ranks, p)
        dims.append((len(ranks), *d[1:]))
        idx = np.ravel_multi_index(coords, dims[-1]).astype(np.int64)
        flat.append(torch.as_tensor(_exec.per_set(idx, int(np.prod(dims[-1])), batch),
                                    device=device))
        sel.append(None if ids is None else torch.as_tensor(ids, device=device))
    rows = [int(np.prod(d)) * (batch or 1) for d in dims]

    def scatter(values, i):
        if sel[i] is not None:
            values = values.index_select(values.ndim - 1 - len(item), sel[i])
        out = torch.zeros((rows[i], *item), dtype=dtype, device=device)
        out[flat[i]] = values.reshape(-1, *item)
        return out.view(*lead, *dims[i], *item)

    def pack(a_values, b_values):
        return scatter(a_values, 0), scatter(b_values, 1)

    return pack


def _rowwise_runner(plan, a_structure, b_structure, *, device, dtype, block, batch=None,
                    group=None):
    p = plan.p
    I, K = a_structure.shape
    _, J = b_structure.shape
    if len(plan.ownership["a_row"]) != I or len(plan.ownership["b_row"]) != K:
        raise ValueError("plan was built for different operand shapes")
    ar, ac = a_structure.coo()
    br, bc = b_structure.coo()
    rdev, rslot = owner_slot(plan.local_ids["a_row"], I)
    bdev, bslot = owner_slot(plan.local_ids["b_row"], K)
    I_max = plan.local_ids["a_row"].shape[1]
    K_max = plan.local_ids["b_row"].shape[1]
    comm = make_comm(p, batch, group)
    # flat indices are int64: the 1D models' dense tables pass 2^31
    # elements at the AMG sizes
    pack = _dense_pack(
        (rdev[ar], rslot[ar], ac), (bdev[br], bslot[br], bc),
        (p, I_max, K), (p, K_max, J), dtype, device, batch=batch, ranks=comm.ranks,
    )
    step = _exec.make_rowwise_step(plan, K, J, device, batch, comm)
    return _setup(pack, step, (a_structure.nnz,), (b_structure.nnz,), (I, J), batch)


def _outer_runner(plan, a_structure, b_structure, *, device, dtype, block, batch=None,
                  group=None):
    p = plan.p
    I, K = a_structure.shape
    _, J = b_structure.shape
    if len(plan.ownership["k"]) != K:
        raise ValueError("plan was built for different operand shapes")
    ar, ac = a_structure.coo()
    br, bc = b_structure.coo()
    kdev, kslot = owner_slot(plan.local_ids["k"], K)
    K_max = plan.local_ids["k"].shape[1]
    comm = make_comm(p, batch, group)
    pack = _dense_pack(
        (kdev[ac], ar, kslot[ac]), (kdev[br], kslot[br], bc),
        (p, I, K_max), (p, K_max, J), dtype, device, batch=batch, ranks=comm.ranks,
    )
    step = _exec.make_outer_step(plan, I, J, batch, comm)
    return _setup(pack, step, (a_structure.nnz,), (b_structure.nnz,), (I, J), batch)


def _owned_pack(plan, nA: int, nB: int, item: tuple[int, ...], dtype, device, batch=None,
                ranks=None):
    """``pack(a_values, b_values)`` scattering value stacks (``(nnz, *item)``)
    into rank-major owned tables (held, N_max, *item) of the held ``ranks``
    (every rank when None) by the plan's ``a_nz`` / ``b_nz`` ownership (a
    leading batch axis on both when batched)."""
    if nA != len(plan.a_part) or nB != len(plan.b_part):
        raise ValueError("plan was built for a different nonzero structure")
    p = plan.p
    adev, aslot = owner_slot(plan.local_ids["a_nz"], nA)
    bdev, bslot = owner_slot(plan.local_ids["b_nz"], nB)
    N_a = plan.local_ids["a_nz"].shape[1]
    N_b = plan.local_ids["b_nz"].shape[1]
    return _dense_pack(
        (adev, aslot), (bdev, bslot), (p, N_a), (p, N_b), dtype, device, item, batch, ranks,
    )


def _fine_runner(plan, a_structure, b_structure, *, device, dtype, block, batch=None,
                 group=None):
    I, _ = a_structure.shape
    _, J = b_structure.shape
    nA, nB = a_structure.nnz, b_structure.nnz
    comm = make_comm(plan.p, batch, group)
    pack = _owned_pack(plan, nA, nB, (), dtype, device, batch, comm.ranks)
    step = _exec.make_fine_step(plan, device, batch, comm)
    return _setup(pack, step, (nA,), (nB,), (I, J), batch)


def _columnwise_runner(plan, a_structure, b_structure, *, device, dtype, block, batch=None,
                       group=None):
    # run rowwise on the transposed operands: the plan was lowered from the
    # C^T = B^T A^T instance, so the inner runner sees A' = B^T, B' = A^T
    # and produces C^T shards; values arrive in the *original* CSR orders
    # and are permuted into the transposed (col-major) orders on the device
    inner = _rowwise_runner(
        plan, b_structure.transpose(), a_structure.transpose(),
        device=device, dtype=dtype, block=block, batch=batch, group=group,
    )
    ar, ac = a_structure.coo()
    br, bc = b_structure.coo()
    # CSR order of X^T enumerates X's nonzeros sorted by (col, row)
    perm_a = torch.as_tensor(np.lexsort((ar, ac)), device=device)
    perm_b = torch.as_tensor(np.lexsort((br, bc)), device=device)

    def pack(a_values, b_values):
        return inner.pack(b_values[..., perm_b], a_values[..., perm_a])

    I, _ = a_structure.shape
    _, J = b_structure.shape
    return _setup(pack, inner.step, (a_structure.nnz,), (b_structure.nnz,), (I, J), batch)


def _monoC_runner(plan, a_structure, b_structure, *, device, dtype, block, batch=None,
                  group=None):
    # a_structure / b_structure are the BLOCK structures here; values are
    # (nnz, block, block) stacks in block CSR (= to_bsr) order
    I, _ = a_structure.shape
    _, J = b_structure.shape
    nA, nB = a_structure.nnz, b_structure.nnz
    comm = make_comm(plan.p, batch, group)
    pack = _owned_pack(plan, nA, nB, (block, block), dtype, device, batch, comm.ranks)
    step = _exec.make_monoC_step(plan, device, block=block, batch=batch, comm=comm)
    return _setup(
        pack, step, (nA, block, block), (nB, block, block), (I * block, J * block), batch
    )


# ---------------------------------------------------------------------------
# unpackers (uniform signature: (plan, c_structure, shape, device) -> fn;
# fn takes rank-major shards with a leading set axis or without one)
# ---------------------------------------------------------------------------
def _unpack_rowwise(plan, c_structure, shape, device):
    return _exec.make_rowwise_unpack(plan, shape[0], device)


def _unpack_columnwise(plan, c_structure, shape, device):
    # the inner rowwise step computed C^T over J rows; transpose back
    unpack_t = _exec.make_rowwise_unpack(plan, shape[1], device)
    return lambda c_local: unpack_t(c_local).transpose(-1, -2)


def _unpack_outer(plan, c_structure, shape, device):
    # (.., p, ceil(I / p), J) row blocks, a leading set axis or none
    return lambda c_local: c_local.reshape(*c_local.shape[:-3], -1, shape[1])[..., : shape[0], :]


# ---------------------------------------------------------------------------
# value packing (canonical 1-D nonzero vectors -> executor value layout)
# ---------------------------------------------------------------------------
def _values_flat(vals, block: int):
    return vals


def _values_blocked(vals, block: int):
    return vals.reshape(*vals.shape[:-1], -1, block, block)


# ---------------------------------------------------------------------------
# the spec and the registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Everything one paper model needs, declared in one place.

    ``measured`` states how the plan's route-counted words relate to the
    model's prediction: "exact" (replicated-free plans — words on the wire
    == the predicted words) or "useful" (unit-cost prediction recovered by
    nnz-weighting, ``item_words``, or fold accounting).  ``in_auto`` gates
    membership in ``model="auto"`` selection.

    ``build is None`` marks a partition-free baseline (summa2d): there is
    no hypergraph — the lowerer goes straight from the instance and the
    prediction is the plan's analytic ``stats["words_analytic"]``.
    """

    name: str
    family: str  # "1D" | "2D" | "3D" (paper Sec. 5 classification)
    build: Callable | None  # (inst, include_nz=False) -> Hypergraph; None: no hypergraph
    lower: Callable  # (inst, parts, p) -> ExecutionPlan
    # (plan, a_s, b_s, *, device, dtype, block, batch=None, group=None) -> RunnerSetup
    make_runner: Callable
    make_unpack: Callable  # (plan, c_structure, shape, device) -> unpack fn
    # (vals, block) -> executor layout, vals (nnz,) or a (sets, nnz) stack
    pack_values: Callable = _values_flat
    item_words: Callable = lambda inst: None  # (inst) -> {route: words-per-item}
    needs_c_structure: bool = False  # unpack requires inst.c
    lower_include_nz: bool = False  # lowerer accepts include_nz partitions
    measured: str | None = None  # "exact" | "useful"
    in_auto: bool = True  # participates in model="auto" selection


def _build(model: str) -> Callable:
    def build(inst: SpGEMMInstance, include_nz: bool = False):
        return build_model(inst, model, include_nz=include_nz)

    return build


MODEL_SPECS: dict[str, ModelSpec] = {
    "fine": ModelSpec(
        name="fine",
        family="3D",
        build=_build("fine"),
        lower=_lower_fine,
        make_runner=_fine_runner,
        make_unpack=_exec.make_fine_unpack,
        needs_c_structure=True,
        # build_fine_plan adopts include_nz vertex placements as ownership
        lower_include_nz=True,
        measured="exact",
    ),
    "rowwise": ModelSpec(
        name="rowwise",
        family="1D",
        build=_build("rowwise"),
        lower=_lower_rowwise,
        make_runner=_rowwise_runner,
        make_unpack=_unpack_rowwise,
        item_words=lambda inst: {"expand": inst.b.row_counts()},
        measured="useful",
    ),
    "columnwise": ModelSpec(
        name="columnwise",
        family="1D",
        build=_build("columnwise"),
        lower=_lower_columnwise,
        make_runner=_columnwise_runner,
        make_unpack=_unpack_columnwise,
        item_words=lambda inst: {"expand": inst.a.col_counts()},
        measured="useful",
    ),
    "outer": ModelSpec(
        name="outer",
        family="1D",
        build=_build("outer"),
        lower=_lower_outer,
        make_runner=_outer_runner,
        make_unpack=_unpack_outer,
        measured="useful",
    ),
    "monoA": ModelSpec(
        name="monoA",
        family="2D",
        build=_build("monoA"),
        lower=_lower_monoA,
        make_runner=_fine_runner,
        make_unpack=_exec.make_fine_unpack,
        needs_c_structure=True,
        measured="exact",
    ),
    "monoB": ModelSpec(
        name="monoB",
        family="2D",
        build=_build("monoB"),
        lower=_lower_monoB,
        make_runner=_fine_runner,
        make_unpack=_exec.make_fine_unpack,
        needs_c_structure=True,
        measured="exact",
    ),
    "monoC": ModelSpec(
        name="monoC",
        family="2D",
        build=_build("monoC"),
        lower=_lower_monoC,
        make_runner=_monoC_runner,
        make_unpack=_exec.make_monoC_unpack,
        pack_values=_values_blocked,
        needs_c_structure=True,
        measured="exact",
    ),
    # -- not a hypergraph model: the oblivious competitor ------------------
    "summa2d": ModelSpec(
        name="summa2d",
        family="2D",
        build=None,
        lower=_lower_summa,
        make_runner=_summa_runner,
        make_unpack=_exec.make_monoC_unpack,  # monoC's rank-major C slots
        pack_values=_values_blocked,
        needs_c_structure=True,
        measured="exact",
        in_auto=False,
    ),
}

assert set(MODELS) <= set(MODEL_SPECS), "registry out of sync with core MODELS"


def get_spec(model: str) -> ModelSpec:
    try:
        return MODEL_SPECS[model]
    except KeyError:
        raise ValueError(
            f"unknown model {model!r}; choose from {tuple(MODEL_SPECS)}"
        ) from None


def executable_models() -> tuple[str, ...]:
    """Names of the paper models with a full plan-lowering + executor path
    that participate in ``model="auto"``, in ``MODELS`` order (the summa2d
    baseline is executable but excluded by ``in_auto=False``)."""
    return tuple(n for n in MODELS if MODEL_SPECS[n].in_auto)
