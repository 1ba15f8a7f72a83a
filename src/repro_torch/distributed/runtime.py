"""Compile-once executor runtime: structure work once, values only per call.

Mirrors ``repro.distributed.runtime``.  The paper's amortization premise is
that the partition — and therefore the plan — is computed once and reused
across many multiplications with the same sparsity structure.
``CompiledSpGEMM`` does all structure-time work exactly once per
(plan, operand structures, ranks and device, dtype, block): the value
scatter indices, route tables, pair lists, kernel run offsets and unpack
indices are uploaded to the device at construction, so ``__call__`` does
no host structure work.  PyTorch runs eagerly, so there is no trace or
compile step; capturing the call as a CUDA graph is later work.

``compile_spgemm`` memoizes executors in a bounded LRU keyed like the
reference's, with its mesh replaced by ``(p, device)`` and the process
group, if any.  With ``group=`` (a ``torch.distributed`` process group of
``plan.p`` processes) the executor is this process's rank alone
(``comm.GroupComm``): it holds only that rank's tables, and its collective
counts only what that rank sends.  ``batch=n`` (with or without a group)
builds
the batched executor for a fixed capacity of n value sets a dispatch (one
more key dimension); callers bucket n through ``batch_bucket`` so ragged
request batches share one executor — the LRU's ``misses`` (``cache_info``)
is the port's counterpart of the reference's ``trace_count()``.

The fault-injection patch points of the reference fire here too:
``"compile"`` when an executor is built, ``"execute"`` on every call.

Which packing, step and unpacking a plan gets is decided by its model's
``registry.ModelSpec``; this module holds no per-model branch.

Value conventions (``__call__`` inputs):

- rowwise, columnwise, outer, fine, monoA, monoB: 1-D (nnz,) value vectors
  in the operands' canonical CSR order (``SparseStructure`` order — what
  ``structure_and_values`` returns);
- monoC: (nnz, b, b) block-value stacks in the *block* structure's CSR order
  (``to_bsr(...).blocks`` order).  The ``repro_torch.api`` front door hides
  this behind ``ModelSpec.pack_values``.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.distributed.registry import get_spec
from repro_torch.sparse.structure import SparseStructure, structure_fingerprint
from repro_torch.testing import faults

__all__ = [
    "CompiledSpGEMM",
    "batch_bucket",
    "cache_clear",
    "cache_info",
    "compile_spgemm",
    "plan_fingerprint",
    "resolve_device",
    "torch_dtype",
]


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or anything numpy reads as one."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


# -- batch-size bucketing ----------------------------------------------------
#: geometric batch-capacity buckets (x2 from 1).  A batched executor is
#: built for a bucket CAPACITY, not a request count: ragged request batches
#: pad up to the same capacity and hit the same executor.
BATCH_GROWTH = 2


def batch_bucket(n: int) -> int:
    """Smallest batch-capacity bucket holding ``n`` items (1, 2, 4, 8, ...)."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    b = 1
    while b < n:
        b *= BATCH_GROWTH
    return b


# -- fingerprints ------------------------------------------------------------
def plan_fingerprint(plan) -> str:
    """Content hash of a plan's executor-visible state, computed once and
    memoized on the plan object (id-stable: repeat lookups are O(1))."""
    fp = getattr(plan, "_fingerprint", None)
    if fp is None:
        h = hashlib.sha1(f"{plan.model}/{plan.p}".encode())
        for tag, group in (
            ("own", plan.ownership),
            ("loc", plan.local_ids),
            ("cmp", plan.compute),
        ):
            for k in sorted(group):
                h.update(f"{tag}:{k}".encode())
                h.update(np.ascontiguousarray(group[k]))
        for k in sorted(plan.routes):
            r = plan.routes[k]
            h.update(f"route:{k}:{r.word_size}".encode())
            h.update(np.ascontiguousarray(r.send_idx))
            h.update(np.ascontiguousarray(r.recv_key))
        fp = h.hexdigest()
        plan._fingerprint = fp
    return fp


# -- the compiled executor ---------------------------------------------------
class CompiledSpGEMM:
    """One SpGEMM executor with its structure work done: values only.

    ``__call__`` takes the value stacks (tensors or numpy arrays, never
    written to) and returns the rank-major C shards of the ranks it holds on
    the executor's device; ``unpack`` turns them into the dense product.
    Built with ``batch=n``, both carry a leading axis of n value sets.

    Built with ``group=`` it holds one rank: every rank of the group
    passes the full value vectors, and ``unpack`` returns the whole dense
    C on every rank (``(sets, I, J)`` when batched), assembled by one
    gather of the ranks' C shards (``comm.gather_ranks``).  That gather is
    outside the counted phases: ``comm.items_moved`` counts the
    algorithm's words alone.

    A call is two halves: ``prepare`` (the ``"execute"`` patch point and
    the packing, local to this process) and ``run`` (the step, whose
    collectives every rank of a group must enter).  A caller over a group
    that retries a failed call agrees on the outcome of ``prepare`` before
    it runs (``resilience.retry_call(group=...)``), so no rank enters an
    exchange a peer will not.
    """

    def __init__(
        self,
        plan,
        a_structure: SparseStructure,
        b_structure: SparseStructure,
        *,
        device=None,
        dtype=torch.float32,
        block: int = 1,
        c_structure: SparseStructure | None = None,
        batch: int | None = None,
        group=None,
    ):
        faults.fire("compile")
        if batch is not None and batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if a_structure.shape[1] != b_structure.shape[0]:
            raise ValueError(
                f"inner dimensions disagree: {a_structure.shape} @ {b_structure.shape}"
            )
        self.plan = plan
        self.model = plan.model
        self.device = resolve_device(device)
        self.dtype = torch_dtype(dtype)
        self.block = block
        self.batch = batch
        spec = get_spec(plan.model)
        self.spec = spec
        setup = spec.make_runner(
            plan,
            a_structure,
            b_structure,
            device=self.device,
            dtype=self.dtype,
            block=block,
            batch=batch,
            group=group,
        )
        self.pack, self.step = setup.pack, setup.step
        self._I, self._J = setup.out_shape
        self._a_shape, self._b_shape = setup.a_shape, setup.b_shape
        self.c_structure = None
        self._unpack = None
        if c_structure is not None or not spec.needs_c_structure:
            self.set_c_structure(c_structure)

    def set_c_structure(self, c_structure: SparseStructure | None) -> None:
        """Upload the unpack indices (for C's (block) structure, where the
        model's unpacking needs it)."""
        self.c_structure = c_structure
        self._unpack = self.spec.make_unpack(
            self.plan, c_structure, (self._I, self._J), self.device
        )

    @property
    def comm(self):
        """The step's collective (counts the items it moves)."""
        return self.step.comm

    def _coerce(self, x, shape, name: str) -> torch.Tensor:
        # a caller's numpy array may be shared, never written: packing
        # scatters it into fresh tables
        x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(
                f"{name} values have shape {tuple(x.shape)}, but this executor "
                f"was built for {shape} — same-structure updates only"
            )
        return x

    def prepare(self, a_values, b_values) -> tuple:
        """The local half of a call: the ``"execute"`` patch point, then the
        value stacks packed into this process's rank-major tables."""
        faults.fire("execute")
        a = self._coerce(a_values, self._a_shape, "A")
        b = self._coerce(b_values, self._b_shape, "B")
        return self.pack(a, b)

    def run(self, tables: tuple) -> torch.Tensor:
        """The step on ``prepare``'s tables (every collective of the call):
        rank-major C shards."""
        return self.step(*tables)

    def __call__(self, a_values, b_values) -> torch.Tensor:
        """Value-only update: returns rank-major C shards (with a leading
        batch axis when built with ``batch=n``)."""
        return self.run(self.prepare(a_values, b_values))

    @property
    def cost_model_words(self) -> tuple[int, int]:
        """(ideal, padded) words per call — what the partition promised and
        what the padded routes actually move."""
        return self.plan.comm_words_ideal, self.plan.comm_words_padded

    def unpack(self, c_local: torch.Tensor) -> torch.Tensor:
        """Turn rank-major C shards into the dense (I, J) tensor (padded
        block-grid shape for monoC) on the executor's device.  A batched
        executor's shards (or a leading slice of them) unpack to
        (sets, I, J) in one index pass.  An executor over a process group
        gathers every rank's shards first."""
        if self._unpack is None:
            raise ValueError(f"unpacking a {self.model} result needs c_structure")
        return self._unpack(self.comm.gather_ranks(c_local))


# -- bounded LRU cache -------------------------------------------------------
CACHE_SIZE = 16
_CACHE: OrderedDict[tuple, CompiledSpGEMM] = OrderedDict()
_STATS = {"hits": 0, "misses": 0}


def _cache_key(plan, a_structure, b_structure, device, dtype, block, batch, group):
    return (
        plan_fingerprint(plan),
        structure_fingerprint(a_structure),
        structure_fingerprint(b_structure),
        (plan.p, str(device)),
        str(dtype),
        block,
        batch,
        None if group is None else id(group),
    )


def compile_spgemm(
    plan,
    a_structure: SparseStructure,
    b_structure: SparseStructure,
    *,
    device=None,
    dtype=torch.float32,
    block: int = 1,
    c_structure: SparseStructure | None = None,
    batch: int | None = None,
    group=None,
) -> CompiledSpGEMM:
    """Get (or build) the executor for a plan + structures + device + dtype
    (+ batch capacity, + process group).  Cache hits return the *same*
    ``CompiledSpGEMM`` object."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    key = _cache_key(plan, a_structure, b_structure, device, dtype, block, batch, group)
    exe = _CACHE.get(key)
    if exe is not None:
        _CACHE.move_to_end(key)
        _STATS["hits"] += 1
        if exe.c_structure is None and c_structure is not None:
            exe.set_c_structure(c_structure)
        return exe
    _STATS["misses"] += 1
    exe = CompiledSpGEMM(
        plan, a_structure, b_structure, device=device, dtype=dtype,
        block=block, c_structure=c_structure, batch=batch, group=group,
    )
    _CACHE[key] = exe
    while len(_CACHE) > CACHE_SIZE:
        _CACHE.popitem(last=False)
    return exe


def cache_info() -> dict:
    return {"size": len(_CACHE), "max_size": CACHE_SIZE, **_STATS}


def cache_clear() -> None:
    _CACHE.clear()
    _STATS["hits"] = _STATS["misses"] = 0
