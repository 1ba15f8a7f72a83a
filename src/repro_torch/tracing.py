"""Spans of the port's layers, kept in memory on the host's clock and, while
a ``torch.profiler`` session records, on the profiler's too.

``span(name, rids=None)`` is a context manager around one piece of a
layer's work.  Its record holds the name, its start and end
(``time.perf_counter_ns``), its parent (the id of the innermost span open
around it on the same thread: each thread keeps its own stack of open
spans) and the ids of the requests it serves.  While it records, the tracer keeps

- per name: calls, total ns and self ns (the total less the time its child
  spans cover);
- the newest ``RECORDS`` raw records (older ones are dropped and counted),

and ``snapshot()`` returns both; ``reset()`` clears them.  Nothing is
written to disk.

A per-call span records only while a ``torch.profiler`` session records or
inside ``recording()``.  While the profiler records, the span also opens a
profiler range of its name (``torch._C._profiler._RecordFunctionFast``, a
``cpu_op`` event of the Chrome trace; ``record_function``'s
``user_annotation`` ranges cost several times as much a range under the
profiler, and stand in where a torch lacks the fast one): each kernel lies in the range that launched it (through the
launch's correlation id), and the k-th record of a name is the k-th range
of that name there.  Otherwise a span site costs a check of two flags and
returns a shared object that does nothing (a profiler range costs
microseconds even with the profiler off).  A set-up span,
``span(name, always=True)``, records always: planning and building an
executor happen a few times a structure and take seconds.

``interval(name, start_s, end_s, rids)`` records a span after the fact,
from two ``time.perf_counter`` stamps: a request's wait in the serving
queue opens before the step that ends it, so it has no parent, is no
span's child and has no profiler range.

The spans (``SPANS``: name -> layer):

- ``serve.queue`` (a request's wait from ``submit`` to its window),
  ``serve.step``, ``serve.dispatch`` (a chunk's requests),
  ``serve.sync`` (the dispatch's wait for the card): ``launch/serve.py``;
- ``session.call``: ``distributed/session.py``;
- ``api.prepare``: ``api.py``;
- ``runtime.copy_in`` (both operands' values to the executor's device and
  dtype), ``runtime.run``, ``runtime.unpack``: ``distributed/runtime.py``;
- ``exec.expand`` (one an operand): ``distributed/spgemm_exec.py``;
- ``k1.launch`` (``bsr_spgemm_local`` whole, its CPU plain path too):
  ``kernels/bsr_spgemm.py``;
- set-up: ``plan.build``, ``plan.partition``, ``plan.lower`` (``api.py``)
  and ``runtime.build`` (an executor built on a miss of the runtime's LRU).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

__all__ = [
    "RECORDS",
    "SPANS",
    "Aggregate",
    "Record",
    "Tracer",
    "interval",
    "recording",
    "reset",
    "snapshot",
    "span",
]

#: raw records kept (the newest): about 10 MB, a few seconds of the
#: busiest loop with every span on, so a long window cannot grow memory
RECORDS = 1 << 16

SPANS = {
    "serve.queue": "serving loop",
    "serve.step": "serving loop",
    "serve.dispatch": "serving loop",
    "serve.sync": "serving loop",
    "session.call": "session",
    "api.prepare": "front door",
    "runtime.copy_in": "runtime",
    "runtime.run": "executor",
    "runtime.unpack": "executor",
    "exec.expand": "executor",
    "k1.launch": "kernel K1",
    "plan.build": "planning",
    "plan.partition": "planning",
    "plan.lower": "planning",
    "runtime.build": "planning",
}


class Record(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None  # the id of the span open around it
    rids: tuple | None  # the ids of the requests it serves


class Aggregate(NamedTuple):
    calls: int
    total_ns: int
    self_ns: int  # total_ns less the time the span's children cover


_OFF = contextlib.nullcontext()  # what a span site gets while nothing records


def _profiler_range(name: str):
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return torch.profiler.record_function(name) if fast is None else fast(name)


class _Span:
    __slots__ = ("tracer", "name", "rids", "id", "open", "parent", "start", "child_ns", "range")

    def __init__(self, tracer: Tracer, name: str, rids):
        self.tracer = tracer
        self.name = name
        self.rids = None if rids is None else tuple(rids)

    def __enter__(self):
        t = self.tracer
        self.id = next(t._ids)
        self.open = t._open_spans()
        self.parent = self.open[-1].id if self.open else None
        self.child_ns = 0
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler_range(self.name)
            self.range.__enter__()
        self.open.append(self)
        self.start = t.clock()
        return self

    def __exit__(self, *exc):
        t = self.tracer
        end = t.clock()
        self.open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        t._add(self.id, self.name, self.start, end, self.parent, self.rids, self.child_ns)
        if self.open:
            self.open[-1].child_ns += end - self.start
        return False


class Tracer:
    """Spans, their per-name aggregates and the newest raw records.  The
    module's functions are those of the process's one tracer."""

    def __init__(self, clock=time.perf_counter_ns, records: int = RECORDS):
        self.clock = clock
        self._recording = 0
        self._local = threading.local()  # .open: the thread's open spans, the innermost last
        self._ids = itertools.count()
        self._lock = threading.Lock()  # the aggregates and records, closed from any thread
        self._totals: dict[str, list[int]] = {}  # name -> [calls, total_ns, self_ns]
        self._records: collections.deque[Record] = collections.deque(maxlen=records)
        self._added = 0

    def span(self, name: str, rids=None, always: bool = False):
        """A context manager timing the work inside it as span ``name``;
        ``rids`` (an iterable of request ids) is read only while the
        tracer records."""
        if self._recording or always or _profiler._is_profiler_enabled:
            return _Span(self, name, rids)
        return _OFF

    def interval(self, name: str, start_s: float, end_s: float, rids=None) -> None:
        """Record span ``name`` from ``start_s`` to ``end_s``
        (``time.perf_counter`` seconds) after the fact, if recording."""
        if self._recording or _profiler._is_profiler_enabled:
            self._add(next(self._ids), name, round(start_s * 1e9), round(end_s * 1e9), None,
                      None if rids is None else tuple(rids), 0)

    @contextlib.contextmanager
    def recording(self):
        """Record every span inside, with or without the profiler."""
        self._recording += 1
        try:
            yield self
        finally:
            self._recording -= 1

    def _open_spans(self) -> list:
        try:
            return self._local.open
        except AttributeError:
            self._local.open = []
            return self._local.open

    def _add(self, sid, name, start, end, parent, rids, child_ns) -> None:
        with self._lock:
            agg = self._totals.get(name)
            if agg is None:
                agg = self._totals[name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += end - start
            agg[2] += end - start - child_ns
            self._records.append(Record(sid, name, start, end, parent, rids))
            self._added += 1

    def snapshot(self) -> dict:
        """``{"spans": {name: Aggregate}, "records": [Record, ...] (oldest
        first, in the order they closed), "dropped": records no longer
        kept}``."""
        with self._lock:
            return {
                "spans": {k: Aggregate(*v) for k, v in self._totals.items()},
                "records": list(self._records),
                "dropped": self._added - len(self._records),
            }

    def reset(self) -> None:
        """Clear the aggregates and records (spans open now still close)."""
        with self._lock:
            self._totals.clear()
            self._records.clear()
            self._added = 0


_TRACER = Tracer()
span = _TRACER.span
interval = _TRACER.interval
recording = _TRACER.recording
snapshot = _TRACER.snapshot
reset = _TRACER.reset
