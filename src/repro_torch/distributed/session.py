"""Resilient SpGEMM sessions: drift-aware replanning over a persistent pool.

The PyTorch counterpart of ``repro.distributed.session``: the same event
sequence, keys, warm labels and store entries on the same traffic, with
executors on a torch device (the card unless ``device="cpu"``) and results
as tensors there.

The paper's amortization story assumes the sparsity structure holds still.
The workloads it benchmarks don't: MCL prunes the matrix every iteration,
AMG's Galerkin products change structure per level.  ``SpGEMMSession`` is
the long-lived handle for those loops — it wraps the ``repro_torch.plan()``
pipeline and the AOT runtime into one object that survives structure drift,
stage failures, and process restarts:

- **Drift detection.**  Every ``multiply(A, B)`` fingerprints the operand
  structures (``sparse.structure.structure_fingerprint``).  An unchanged
  pair hits the warm executor pool (zero planning, no executor rebuilt); a
  changed pair triggers a replan that *warm-starts* the partitioner from
  the previous labels: old vertices are matched to new ones by canonical
  per-model keys (row index, column index, (i,k,j) multiplication triple,
  (row,col) C coordinate), the surviving labels seed
  ``partition(..., warm_start=...)``, and cold partitioning runs only when
  drift exceeds the threshold or the warm result is infeasible.

- **Persistence.**  With ``store_dir`` set, every planned entry is written
  through ``checkpoint.save_plan`` (atomic, checksummed, versioned).  A
  restarted session rebuilds its warm pool from disk: restored plans are
  content-identical, so their fingerprints match and compilation hits the
  process-wide executor LRU — no re-partitioning, no rebuilt executor.  Corrupt
  entries are quarantined by the store and simply replanned.

- **Fault policy.**  A ``resilience.FaultPolicy`` governs every stage:
  transient failures (per ``is_retryable``) are retried with backoff;
  persistent partition failures walk the engine chain (device -> flat);
  persistent compile/execute failures walk the model chain
  (fine -> monoC -> rowwise), replanning with the cheaper model.  Every
  decision is recorded on ``session.events`` so tests and benchmarks can
  assert exactly what happened.  ``engine="device"`` partitions on the
  session's device; a device partitioner that fails raises in
  ``partition``, and the session reports that as an ``engine_fallback`` to
  ``"flat"``.  A kernel of the port that fails on the card
  (``kernels.KernelError``: no build, no load, refused inputs, a failed
  launch) is never downgraded around: the session raises it.

- **Ranks in processes.**  With ``group=`` (a ``torch.distributed`` group
  of p processes, each making the same calls with the same operands) every
  rank holds its own executors (``compile(group=...)``) and returns the
  whole product.  The reference's session is one SPMD program; here a
  retry or a downgrade that one rank took and its peers did not would
  leave the peers waiting in a collective, so every decision is
  collective: each compile and each execute attempt ends in an agreement
  over the group (``resilience.retry_call(group=...)``; for execute,
  after the local half of the call and before its first exchange), and a
  stage that failed on any rank failed on all.  Rank 0 alone partitions
  or reads the plan store and writes it, and hands its plan, or its
  failure, and the events it recorded to the others in one broadcast
  (``_on_root``), so a ``partition``, ``store_save`` or ``store_restore``
  fault lives on rank 0 alone and the host plans once.  Every rank
  records the same events, and the same as one process on the same
  traffic.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import Counter, OrderedDict

import numpy as np

from repro_torch import tracing
from repro_torch.distributed.runtime import resolve_device, torch_dtype
from repro_torch.kernels import KernelError
from repro_torch.resilience import FaultPolicy, PeerFailure, retry_call
from repro_torch.sparse.structure import structure_and_values, structure_fingerprint

__all__ = ["SessionEvent", "SpGEMMSession"]


@dataclasses.dataclass
class SessionEvent:
    """One recorded session decision (pool hit, replan, retry, downgrade...)."""

    kind: str  # hit | warm_replan | cold_replan | restored | saved | evict |
    # retry | engine_fallback | model_downgrade | store_error
    key: str  # structure-pair key the decision applies to
    model: str | None = None
    detail: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Entry:
    """One warm pool slot: a planned + compiled pipeline and the label/key
    arrays future drifted structures warm-start from."""

    key: str
    model: str
    planned: object  # api.PlannedSpGEMM
    exe: object  # api.CompiledSpGEMM, on the session's device
    labels: np.ndarray  # partition of the model's vertices
    vertex_keys: np.ndarray  # canonical per-vertex match keys
    shape: tuple[int, int, int]


def _vertex_keys(inst, model: str) -> np.ndarray:
    """Canonical global id per partition vertex — the drift-stable identity
    used to carry labels across structure changes.  Vertices present in both
    the old and new structure (same row / column / multiplication / C
    coordinate) keep their label; everything else is placed fresh."""
    I, K, J = inst.shape
    if model == "rowwise":
        return np.arange(I, dtype=np.int64)
    if model == "outer":
        return np.arange(K, dtype=np.int64)
    if model == "fine":
        return (inst.mult_i * K + inst.mult_k) * J + inst.mult_j
    if model == "monoC":
        rows, cols = inst.c.coo()
        return rows * J + cols
    raise ValueError(f"no warm-start vertex keys for model {model!r}")


def _map_labels(
    old_keys: np.ndarray, old_labels: np.ndarray, new_keys: np.ndarray
) -> np.ndarray:
    """Carry labels from old vertices to new ones by key match; unmatched
    new vertices get -1 (the partitioner's 'place me fresh' marker)."""
    out = np.full(len(new_keys), -1, dtype=np.int64)
    if len(old_keys) == 0 or len(new_keys) == 0:
        return out
    order = np.argsort(old_keys, kind="stable")
    sorted_keys = old_keys[order]
    pos = np.searchsorted(sorted_keys, new_keys)
    pos = np.minimum(pos, len(sorted_keys) - 1)
    hit = sorted_keys[pos] == new_keys
    out[hit] = old_labels[order][pos[hit]]
    return out


class SpGEMMSession:
    """Failure-tolerant handle for iterated, structure-drifting SpGEMM.

    Construct via ``repro_torch.session(...)``.  ``multiply(A, B)`` returns
    the dense product as a tensor on ``device``; everything else (planning, warm-starting, compiling,
    persisting, retrying, downgrading) happens behind it and is visible on
    ``session.events`` / ``session.stats()``.
    """

    def __init__(
        self,
        p: int = 8,
        model: str = "auto",
        eps: float = 0.10,
        seed: int = 0,
        engine: str = "flat",
        store_dir: str | None = None,
        policy: FaultPolicy | None = None,
        warm_drift_limit: float = 0.5,
        max_entries: int = 8,
        dtype=np.float32,
        device=None,
        group=None,
    ):
        self.group = group
        self.rank = 0
        if group is not None:
            import torch.distributed as dist

            if dist.get_world_size(group) != p:
                raise ValueError(f"a session of p = {p} ranks cannot run over a process "
                                 f"group of {dist.get_world_size(group)}")
            self.rank = dist.get_rank(group)
        self.p = p
        self.model = model
        self.eps = eps
        self.seed = seed
        self.engine = engine
        self.store_dir = store_dir
        self.policy = policy or FaultPolicy()
        self.warm_drift_limit = warm_drift_limit
        self.max_entries = max_entries
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        self.events: list[SessionEvent] = []
        self._pool: OrderedDict[str, _Entry] = OrderedDict()
        self._last: _Entry | None = None
        # "auto" resolves on the first plan and then stays put: re-selecting
        # per drifted structure would defeat warm-starting (labels only carry
        # within one model's vertex space)
        self._model_resolved: str | None = None if model == "auto" else model

    # -- public API --------------------------------------------------------
    def entry_for(self, a_s, b_s) -> _Entry:
        """The warm pool entry for a structure pair, planning/restoring as
        needed (and classifying the access as hit / restored / warm_replan /
        cold_replan on ``events``).  This is the session's planning half —
        ``multiply`` executes through it, and the serving loop
        (``repro_torch.launch.serve``) batches through it."""
        key = self._key(a_s, b_s)
        entry = self._pool.get(key)
        if entry is not None:
            self._pool.move_to_end(key)
            self._event("hit", key, entry.model)
        else:
            from repro_torch.core.spgemm_models import SpGEMMInstance

            inst = SpGEMMInstance.from_operands(a_s, b_s, name="session")
            entry = self._restore(key, inst)
            if entry is None:
                entry = self._plan_entry(key, inst)
                self._persist(entry)
            self._admit(entry)
        self._last = entry
        return entry

    def multiply(self, A, B):
        """Dense C = A @ B (a tensor on the session's device), planning,
        compiling and restoring only as needed.

        ``A`` / ``B`` are dense arrays, scipy sparse matrices, or
        ``(SparseStructure, values)`` pairs (values in canonical CSR order).
        """
        a_s, a_vals = structure_and_values(A)
        b_s, b_vals = structure_and_values(B)
        entry = self.entry_for(a_s, b_s)
        c = self._execute(entry, a_vals, b_vals, entry.key)
        self._last = self._pool.get(entry.key, self._last)
        return c

    def call(self, exe, a_vals, b_vals):
        """``exe(a_vals, b_vals)`` (a compiled handle of this session's
        entries) under the policy's retries at stage ``"execute"``.  Over a
        group the retried half is ``exe.prepare`` (packing and the patch
        point) alone, agreed by every rank before any runs the exchanges;
        a failure past that point is raised."""
        with tracing.span("session.call"):
            if self.group is None:
                return self._retry(lambda: exe(a_vals, b_vals), "execute")
            return exe.run(self._retry(lambda: exe.prepare(a_vals, b_vals), "execute"))

    __call__ = multiply

    def stats(self) -> dict:
        """Event counts + pool occupancy — the session's accounting view."""
        counts = Counter(e.kind for e in self.events)
        return {
            "pool_size": len(self._pool),
            "model": self._model_resolved or self.model,
            "events": dict(counts),
        }

    # -- internals ---------------------------------------------------------
    def _event(self, kind: str, key: str, model: str | None = None, **detail):
        ev = SessionEvent(kind=kind, key=key, model=model, detail=detail)
        self.events.append(ev)
        return ev

    def _on_retry(self, stage: str, attempt: int, exc: BaseException):
        self._event("retry", "", None, stage=stage, attempt=attempt, error=repr(exc))

    def _retry(self, fn, stage: str, group=True):
        """``fn()`` under the policy's retries, agreed over the session's
        group (if any, and ``group``); a ``KernelError`` is raised at
        once."""
        return retry_call(fn, self.policy, stage=stage, on_retry=self._on_retry,
                          group=self.group if group else None, fatal=(KernelError,))

    def _on_root(self, fn, stage: str, ship=lambda out: out):
        """``fn()`` on rank 0 alone; every rank returns its result (the
        others ``ship(result)``) and records the events it recorded, or
        raises if it raised (the others a ``PeerFailure``): one
        ``broadcast_object_list``.  Without a group, ``fn()``."""
        if self.group is None:
            return fn()
        import torch.distributed as dist

        n_events, error, msg = len(self.events), None, [None]
        if self.rank == 0:
            try:
                out = fn()
                msg[0] = (ship(out), None, self.events[n_events:])
            except KernelError:
                raise
            except Exception as exc:
                error = exc
                msg[0] = (None, repr(exc), self.events[n_events:])
        dist.broadcast_object_list(msg, src=dist.get_global_rank(self.group, 0),
                                   group=self.group)
        shipped, failure, events = msg[0]
        if self.rank == 0:
            if error is not None:
                raise error
            return out
        self.events.extend(events)
        if failure is not None:
            raise PeerFailure(f"stage {stage!r} failed on rank 0: {failure}")
        return shipped

    def _key(self, a_s, b_s) -> str:
        ident = (
            f"{structure_fingerprint(a_s)}/{structure_fingerprint(b_s)}"
            f"/p={self.p}/model={self.model}/eps={self.eps!r}/seed={self.seed}"
        )
        return hashlib.sha1(ident.encode()).hexdigest()

    def _admit(self, entry: _Entry) -> None:
        self._pool[entry.key] = entry
        self._pool.move_to_end(entry.key)
        while len(self._pool) > self.max_entries:
            old_key, old = self._pool.popitem(last=False)
            # the plan survives on disk (if a store is configured) and the
            # executable in the runtime LRU; only the pool slot is reclaimed
            self._event("evict", old_key, old.model)

    # -- planning ----------------------------------------------------------
    def _plan_entry(self, key: str, inst) -> _Entry:
        """Plan + compile an entry, walking the model downgrade chain on
        persistent failures."""
        start = self._model_resolved or self.model
        models = [start, *self.policy.downgrades(start, self.policy.model_chain)]
        last_exc: BaseException | None = None
        for i, model in enumerate(models):
            if i:
                self._event(
                    "model_downgrade",
                    key,
                    model,
                    from_model=models[i - 1],
                    error=repr(last_exc),
                )
            try:
                return self._build_entry(key, inst, model)
            except KernelError:
                raise
            except Exception as exc:
                last_exc = exc
        raise last_exc

    def _compile(self, planned):
        return self._retry(
            lambda: planned.compile(device=self.device, dtype=self.dtype, group=self.group),
            "compile",
        )

    def _build_entry(self, key: str, inst, model: str) -> _Entry:
        warm_labels, drift = self._warm_labels(inst, model)
        # rank 0 plans; the others get the plan without the hypergraph and
        # the instance, which they hold
        planned = self._on_root(
            lambda: self._plan_model(key, inst, model, warm_labels), "partition",
            ship=lambda out: dataclasses.replace(out, instance=None, hypergraph=None),
        )
        if planned.instance is None:
            planned.instance = inst
        self._model_resolved = planned.model
        exe = self._compile(planned)
        warm = bool(getattr(planned.partition, "warm", False))
        self._event(
            "warm_replan" if warm else "cold_replan",
            key,
            planned.model,
            drift=drift,
            connectivity=int(planned.partition.connectivity),
        )
        return _Entry(
            key=key,
            model=planned.model,
            planned=planned,
            exe=exe,
            labels=np.asarray(planned.partition.parts),
            vertex_keys=_vertex_keys(inst, planned.model),
            shape=tuple(inst.shape),
        )

    def _plan_model(self, key: str, inst, model: str, warm_labels):
        """Run the planning pipeline, walking the engine downgrade chain on
        persistent partitioner failures."""
        from repro_torch import api

        engines = [
            self.engine,
            *self.policy.downgrades(self.engine, self.policy.engine_chain),
        ]
        last_exc: BaseException | None = None
        for i, eng in enumerate(engines):
            if i:
                self._event(
                    "engine_fallback", key, model, engine=eng, error=repr(last_exc)
                )

            def attempt(eng=eng):
                if model == "auto":
                    return api.plan(
                        inst,
                        p=self.p,
                        model="auto",
                        eps=self.eps,
                        seed=self.seed,
                        engine=eng,
                        device=self.device,
                    )
                return api._plan_one(
                    inst,
                    model,
                    self.p,
                    self.eps,
                    self.seed,
                    include_nz=False,
                    engine=eng,
                    warm_start=warm_labels,
                    warm_drift_limit=self.warm_drift_limit,
                    device=self.device,
                )

            try:
                return self._retry(attempt, "partition", group=False)
            except Exception as exc:
                last_exc = exc
        raise last_exc

    def _warm_labels(self, inst, model: str):
        """Map a previous entry's labels onto this instance's vertex set.
        Returns (labels-with--1-holes | None, drift fraction | None).

        Candidates are the last-touched entry plus every pool entry with the
        same model and shape, most recent first; the one with the lowest
        drift wins.  Searching the pool (not just ``_last``) matters for
        serving traffic, where several structures interleave and the drifted
        request's true predecessor is rarely the last entry touched."""
        if model == "auto":
            return None, None
        shape = tuple(inst.shape)
        candidates, seen = [], set()
        for ent in (self._last, *reversed(self._pool.values())):
            if ent is None or id(ent) in seen:
                continue
            seen.add(id(ent))
            if ent.model == model and ent.shape == shape:
                candidates.append(ent)
        if not candidates:
            return None, None
        new_keys = _vertex_keys(inst, model)
        best_labels, best_drift = None, None
        for ent in candidates:
            labels = _map_labels(ent.vertex_keys, ent.labels, new_keys)
            drift = float((labels < 0).mean()) if len(labels) else 1.0
            if best_drift is None or drift < best_drift:
                best_labels, best_drift = labels, drift
                if drift == 0.0:
                    break
        return best_labels, best_drift

    # -- execution ---------------------------------------------------------
    def _execute(self, entry: _Entry, a_vals, b_vals, key: str):
        try:
            return self.call(entry.exe, a_vals, b_vals)
        except KernelError:
            raise
        except Exception as exc:
            # persistent execute failure: replan with the next model down
            last_exc = exc
            inst = entry.planned.instance
            prev_model = entry.model
            for model in self.policy.downgrades(entry.model, self.policy.model_chain):
                self._event(
                    "model_downgrade",
                    key,
                    model,
                    from_model=prev_model,
                    error=repr(last_exc),
                )
                try:
                    entry2 = self._build_entry(key, inst, model)
                    c = self.call(entry2.exe, a_vals, b_vals)
                except KernelError:
                    raise
                except Exception as exc2:
                    last_exc = exc2
                    prev_model = model
                    continue
                self._model_resolved = entry2.model
                self._admit(entry2)
                self._persist(entry2)
                return c
            raise last_exc

    # -- persistence -------------------------------------------------------
    def _persist(self, entry: _Entry) -> None:
        if self.store_dir is None or entry.planned.execution_plan is None:
            return
        self._on_root(lambda: self._save(entry), "store_save")

    def _save(self, entry: _Entry) -> None:
        """Write ``entry`` to the store (rank 0's part of ``_persist``)."""
        from repro_torch.checkpoint import save_plan

        meta = {
            "model": entry.model,
            "p": self.p,
            "eps": self.eps,
            "seed": self.seed,
            "shape": list(entry.shape),
            "connectivity": int(entry.planned.partition.connectivity),
        }
        try:
            self._retry(
                lambda: save_plan(
                    self.store_dir,
                    entry.key,
                    entry.planned.execution_plan,
                    arrays={
                        "labels": entry.labels,
                        "vertex_keys": entry.vertex_keys,
                    },
                    meta=meta,
                ),
                "store_save",
                group=False,
            )
        except Exception as exc:
            # persistence is an optimization; losing it costs a future
            # replan, never the current multiply
            self._event("store_error", entry.key, entry.model, op="save", error=repr(exc))
            return
        self._event("saved", entry.key, entry.model)

    def _read(self, key: str):
        """The store's entry for ``key`` (None if none or unreadable; rank
        0's part of ``_restore``)."""
        from repro_torch.checkpoint import restore_plan

        try:
            return self._retry(lambda: restore_plan(self.store_dir, key), "store_restore",
                               group=False)
        except Exception as exc:
            self._event("store_error", key, None, op="restore", error=repr(exc))
            return None

    def _restore(self, key: str, inst) -> _Entry | None:
        if self.store_dir is None:
            return None
        restored = self._on_root(lambda: self._read(key), "store_restore")
        if restored is None:
            return None
        meta = restored.meta
        model = meta.get("model")
        if meta.get("p") != self.p or model is None:
            return None
        from repro_torch.api import PlannedSpGEMM
        from repro_torch.core.partition import PartitionResult

        labels = restored.arrays.get("labels")
        keys = restored.arrays.get("vertex_keys")
        if labels is None or keys is None:
            return None
        pres = PartitionResult(
            parts=np.asarray(labels),
            p=self.p,
            connectivity=int(meta.get("connectivity", 0)),
        )
        planned = PlannedSpGEMM(
            instance=inst,
            model=model,
            hypergraph=None,  # cost analysis unavailable on restored handles
            partition=pres,
            execution_plan=restored.plan,
            eps=self.eps,
            seed=self.seed,
        )
        try:
            exe = self._compile(planned)
        except KernelError:
            raise
        except Exception as exc:
            # a stored plan that no longer compiles is worth exactly nothing:
            # fall through to a fresh replan
            self._event("store_error", key, model, op="compile", error=repr(exc))
            return None
        self._model_resolved = model
        self._event("restored", key, model)
        return _Entry(
            key=key,
            model=model,
            planned=planned,
            exe=exe,
            labels=np.asarray(labels),
            vertex_keys=np.asarray(keys),
            shape=tuple(meta.get("shape", inst.shape)),
        )
