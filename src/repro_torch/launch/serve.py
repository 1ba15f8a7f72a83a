"""SpGEMM serving loop: warm pool of compiled handles + batched value streams.

The PyTorch counterpart of ``repro.launch.serve``, on one torch device (the
card unless ``device="cpu"``): the p ranks of every plan run stacked on it
(``Loopback``), and results are tensors there.  With ``group=`` (a
``torch.distributed`` group of p processes) the ranks run one a process,
the counterpart of the reference's serving over p devices: rank 0 holds
the queue, admits, batches and accounts, and sends each window's work to
the others, which run ``follow()`` and make the same dispatches with it.

The paper's premise makes SpGEMM a compile-once workload: the expensive work
(partition, lower, build the executor) is per-*structure*, while production traffic
(AMG setup chains, MCL iterations, multi-RHS products) re-runs the same
structure with new values thousands of times.  This module is the traffic
side of that story — a bounded request queue drained by a loop that

- **classifies** every request by structure fingerprint through a
  ``SpGEMMSession`` warm pool: an unchanged structure is a pool hit
  (zero planning), a drifted one warm-start-replans, a new one plans cold,
  and the pool's LRU eviction + optional plan store bound memory;
- **batches** same-structure requests into one dispatch through the batched
  executor (``PlannedSpGEMM.compile(batch=n)``): value batches are padded to
  geometric capacity buckets so ragged batch sizes share one executor (the
  runtime LRU holds one executor per bucket);
- **accounts** per-request latency (p50/p99), aggregate throughput (QPS),
  and batch efficiency (items shipped / padded slots).  A request is done
  when its result is on the device: a dispatch synchronizes the card
  before it stamps ``t_done``, so latency and QPS time the card's work,
  not the launch queue.

Admission is reject-on-full (``QueueFull``): a bounded queue keeps worst-case
latency bounded and pushes overload back to the caller.  Execution failures
go through the session's ``FaultPolicy`` (transients retried with backoff);
a batch that fails permanently marks only its own requests failed — the loop
keeps serving.

Usage, from the repository root (``--device cpu`` runs the plain PyTorch
path on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.serve --p 4 --requests 64 --smoke

and with the p ranks one a process (``launch.ranks.run_ranks``):

  PYTHONPATH=src python -m repro_torch.launch.serve --p 4 --ranks --smoke
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import OrderedDict

import numpy as np

import torch

from repro_torch import tracing
from repro_torch.resilience import FaultPolicy, retry_call
from repro_torch.sparse.structure import structure_and_values, structure_fingerprint

__all__ = [
    "QueueFull",
    "Request",
    "ServeConfig",
    "ServeStats",
    "SpGEMMServer",
    "serve_spgemm",
]


class QueueFull(RuntimeError):
    """Admission rejection: the bounded request queue is at capacity."""


@dataclasses.dataclass
class ServeConfig:
    """Serving-loop knobs (defaults sized for the in-container smoke)."""

    p: int = 4
    model: str = "auto"
    eps: float = 0.10
    seed: int = 0
    engine: str = "flat"
    max_batch: int = 8  # largest per-dispatch value batch (bucket ceiling)
    batch_window: int = 32  # requests drained per step() across structures
    queue_limit: int = 256  # admission bound; submit() raises QueueFull past it
    pool_entries: int = 8  # warm pool LRU slots (session max_entries)
    store_dir: str | None = None  # plan persistence (survives restarts)
    dtype: str = "float32"
    policy: FaultPolicy | None = None
    device: str | None = None  # None: the card
    group: object = None  # a process group of p ranks, one a process; None: one process


@dataclasses.dataclass
class Request:
    """One queued multiply: structures + canonical CSR values + timestamps."""

    rid: int
    a_s: object  # SparseStructure
    b_s: object
    a_vals: np.ndarray
    b_vals: np.ndarray
    t_submit: float
    result: torch.Tensor | None = None  # on the server's device
    error: BaseException | None = None
    t_start: float | None = None  # left the queue for a window
    t_done: float | None = None

    @property
    def done(self) -> bool:
        return self.t_done is not None

    @property
    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_submit


@dataclasses.dataclass
class ServeStats:
    """Aggregate accounting for one server lifetime."""

    submitted: int = 0
    completed: int = 0
    failed: int = 0
    rejected: int = 0
    dispatches: int = 0
    batch_items: int = 0  # real multiplies shipped
    batch_slots: int = 0  # padded capacity those dispatches were compiled for

    @property
    def batch_efficiency(self) -> float:
        """Items shipped / padded batch slots (1.0 == no padding waste)."""
        return self.batch_items / self.batch_slots if self.batch_slots else 0.0


class SpGEMMServer:
    """The serving loop: bounded queue -> structure groups -> batched dispatch.

    ``submit(A, B)`` enqueues a multiply (rejecting when the queue is full);
    ``step()`` drains one batching window — it groups queued requests by
    structure fingerprint, fetches each group's warm pool entry through the
    session (hit / warm replan / cold plan / restore, all on
    ``server.session.events``), and streams each group through the batched
    executor in ``max_batch``-bounded chunks.  ``drain()`` loops ``step()``
    until the queue is empty.  All results land on the ``Request`` objects.

    Over a process group (``group=``), rank 0 is this loop and the only
    rank that takes ``submit``, ``step``, ``drain`` and ``report``: each
    ``step`` first broadcasts its window (every structure group's key, the
    structures the other ranks have not been sent, and the values) and
    ``close`` tells them to stop.  The other ranks run ``follow()``, which
    serves each window it receives through the same session calls and
    dispatches, so every collective has all its ranks.  Every rank gets
    every result; the accounting is rank 0's.
    """

    def __init__(self, config: ServeConfig | None = None, **overrides):
        from repro_torch.distributed.session import SpGEMMSession

        cfg = config or ServeConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.config = cfg
        self.session = SpGEMMSession(
            p=cfg.p,
            model=cfg.model,
            eps=cfg.eps,
            seed=cfg.seed,
            engine=cfg.engine,
            store_dir=cfg.store_dir,
            policy=cfg.policy,
            max_entries=cfg.pool_entries,
            dtype=cfg.dtype,
            device=cfg.device,
            group=cfg.group,
        )
        self.rank = self.session.rank
        # structures rank 0 has sent to the others (key -> structures there)
        self._sent: OrderedDict[str, tuple | None] = OrderedDict()
        self.stats = ServeStats()
        self._queue: OrderedDict[int, Request] = OrderedDict()
        self._latencies: list[float] = []
        self._next_rid = 0
        self._t_first: float | None = None
        self._t_last: float | None = None

    # -- admission ---------------------------------------------------------
    def submit(self, A, B) -> Request:
        """Enqueue C = A @ B.  ``A``/``B`` are dense arrays, scipy sparse
        matrices, or ``(SparseStructure, values)`` pairs.  Raises
        :class:`QueueFull` when the queue is at ``queue_limit`` — overload
        is the caller's problem by design (bounded worst-case latency)."""
        self._leader_only("submit")
        if len(self._queue) >= self.config.queue_limit:
            self.stats.rejected += 1
            raise QueueFull(
                f"queue at capacity ({self.config.queue_limit}); retry after drain"
            )
        a_s, a_vals = structure_and_values(A)
        b_s, b_vals = structure_and_values(B)
        req = Request(
            rid=self._next_rid,
            a_s=a_s,
            b_s=b_s,
            a_vals=np.asarray(a_vals),
            b_vals=np.asarray(b_vals),
            t_submit=time.perf_counter(),
        )
        self._next_rid += 1
        self._queue[req.rid] = req
        self.stats.submitted += 1
        if self._t_first is None:
            self._t_first = req.t_submit
        return req

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    # -- the loop ----------------------------------------------------------
    def step(self) -> int:
        """Drain one batching window; returns the number of requests served
        (completed or failed).  Requests leave the queue in FIFO order, but
        same-structure requests inside the window ride one dispatch."""
        with tracing.span("serve.step"):
            window: list[Request] = []
            while self._queue and len(window) < self.config.batch_window:
                _, req = self._queue.popitem(last=False)
                req.t_start = time.perf_counter()
                tracing.interval("serve.queue", req.t_submit, req.t_start, (req.rid,))
                window.append(req)
            if not window:
                return 0
            groups: OrderedDict[str, list[Request]] = OrderedDict()
            for req in window:
                key = f"{structure_fingerprint(req.a_s)}/{structure_fingerprint(req.b_s)}"
                groups.setdefault(key, []).append(req)
            if self.session.group is not None:
                self._leader_only("step")
                self._broadcast([
                    (key, self._ship(key, reqs[0]), [(r.a_vals, r.b_vals) for r in reqs],
                     self.config.max_batch)
                    for key, reqs in groups.items()
                ])
            served = 0
            for reqs in groups.values():
                served += self._serve_group(reqs, self.config.max_batch)
            return served

    def drain(self, max_steps: int | None = None) -> int:
        """Run ``step()`` until the queue empties; returns requests served."""
        served = 0
        steps = 0
        while self._queue:
            served += self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return served

    # -- ranks in processes --------------------------------------------------
    #: structures the ranks keep for the windows to come (an LRU, the same
    #: on every rank)
    KEPT_STRUCTURES = 64

    def _leader_only(self, what: str) -> None:
        if self.rank != 0:
            raise RuntimeError(f"{what}() runs on rank 0; rank {self.rank} runs follow()")

    def _broadcast(self, msg):
        """Rank 0's ``msg`` on every rank (one ``broadcast_object_list``)."""
        import torch.distributed as dist

        group = self.session.group
        box = [msg]
        dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
        return box[0]

    def _ship(self, key: str, req: Request) -> tuple | None:
        """The structures of ``key`` to send with a window: None where the
        other ranks keep them."""
        if key in self._sent:
            self._sent.move_to_end(key)
            return None
        self._keep(key, None)
        return req.a_s, req.b_s

    def _keep(self, key: str, structures) -> None:
        self._sent[key] = structures
        while len(self._sent) > self.KEPT_STRUCTURES:
            self._sent.popitem(last=False)

    def follow(self) -> int:
        """A rank other than 0: serve every window rank 0 broadcasts, until
        it sends the stop (``close``); returns the requests served."""
        if self.session.group is None or self.rank == 0:
            raise RuntimeError("follow() runs on the ranks other than 0 of a group")
        served = 0
        while (window := self._broadcast(None)) is not None:
            for key, structures, values, max_batch in window:
                if structures is None:
                    self._sent.move_to_end(key)
                    structures = self._sent[key]
                else:
                    self._keep(key, structures)
                now = time.perf_counter()
                reqs = [Request(-1, *structures, a, b, now) for a, b in values]
                served += self._serve_group(reqs, max_batch)
        return served

    def close(self) -> None:
        """Rank 0: tell the other ranks' ``follow()`` to return.  Without a
        group, nothing."""
        if self.session.group is not None:
            self._leader_only("close")
            self._broadcast(None)

    # -- dispatch ----------------------------------------------------------
    def _serve_group(self, reqs: list[Request], max_batch: int) -> int:
        """One structure group: fetch the warm entry, stream the values
        through the batched executor in ``max_batch``-bounded chunks."""
        try:
            entry = self.session.entry_for(reqs[0].a_s, reqs[0].b_s)
        except Exception as exc:
            return self._fail(reqs, exc)
        served = 0
        for i in range(0, len(reqs), max_batch):
            chunk = reqs[i : i + max_batch]
            with tracing.span("serve.dispatch", (r.rid for r in chunk)):
                served += self._dispatch(entry, chunk)
        return served

    def _compile_batched(self, entry, m: int):
        """The entry's executor for a batch of m; over a group the ranks
        agree on the outcome (no retry) before any goes on."""
        session = self.session

        def build():
            return entry.planned.compile(batch=m, dtype=session.dtype, device=session.device,
                                         group=session.group)

        if session.group is None:
            return build()
        once = dataclasses.replace(session.policy, max_retries=0)
        return retry_call(build, once, stage="compile", group=session.group)

    def _dispatch(self, entry, chunk: list[Request]) -> int:
        m = len(chunk)
        device = self.session.device
        try:
            if m == 1:
                # singletons ride the entry's own (unbatched) executor
                exe, capacity = entry.exe, 1
                a, b = chunk[0].a_vals, chunk[0].b_vals
            else:
                exe = self._compile_batched(entry, m)
                capacity = exe.batch_capacity
                a = np.stack([r.a_vals for r in chunk])
                b = np.stack([r.b_vals for r in chunk])
            c = self.session.call(exe, a, b)
            with tracing.span("serve.sync"):
                if device.type == "cuda":
                    # done means on the card: the launches return before it is
                    torch.cuda.synchronize(device)
        except Exception as exc:
            return self._fail(chunk, exc)
        now = time.perf_counter()
        self.stats.dispatches += 1
        self.stats.batch_items += m
        self.stats.batch_slots += capacity
        for i, req in enumerate(chunk):
            req.result = c if m == 1 else c[i]
            req.t_done = now
            self._latencies.append(req.latency_s)
        self.stats.completed += m
        self._t_last = now
        return m

    def _fail(self, reqs: list[Request], exc: BaseException) -> int:
        now = time.perf_counter()
        for req in reqs:
            req.error = exc
            req.t_done = now
        self.stats.failed += len(reqs)
        self._t_last = now
        return len(reqs)

    # -- accounting --------------------------------------------------------
    def report(self) -> dict:
        """Latency / throughput / batching / classification summary."""
        lat = np.asarray(self._latencies) if self._latencies else np.zeros(0)
        elapsed = (
            (self._t_last - self._t_first)
            if self._t_first is not None and self._t_last is not None
            else 0.0
        )
        s = self.stats
        session_stats = self.session.stats()
        return {
            "submitted": s.submitted,
            "completed": s.completed,
            "failed": s.failed,
            "rejected": s.rejected,
            "dispatches": s.dispatches,
            "qps": round(s.completed / elapsed, 1) if elapsed > 0 else 0.0,
            "p50_us": int(np.percentile(lat, 50) * 1e6) if lat.size else 0,
            "p99_us": int(np.percentile(lat, 99) * 1e6) if lat.size else 0,
            "batch_efficiency": round(s.batch_efficiency, 3),
            "pool": session_stats,
        }


def serve_spgemm(workload, config: ServeConfig | None = None, **overrides):
    """Drive a whole workload through one server: submit everything (stepping
    inline when the queue fills), drain, and return (requests, report).

    ``workload`` is an iterable of (A, B) operand pairs.  This is the
    offline/batched entry point — the benchmark and the CLI both use it; a
    live system would call ``submit``/``step`` from its own event loop.
    Over a process group (``group=``) every rank calls it: rank 0 serves
    ``workload`` and returns as above, the others follow it and return
    ``([], None)``.
    """
    server = SpGEMMServer(config, **overrides)
    if server.rank != 0:  # a follower of a process group: rank 0 has the workload
        server.follow()
        return [], None
    requests = []
    for A, B in workload:
        while True:
            try:
                requests.append(server.submit(A, B))
                break
            except QueueFull:
                server.step()
    server.drain()
    server.close()
    return requests, server.report()


# ---------------------------------------------------------------------------
# CLI: synthetic mixed traffic (pool hits, drifting structures, cold loads)
# ---------------------------------------------------------------------------
def _mixed_workload(n, density, structures, requests, drift, seed):
    """(A, B) pairs mixing the three serving regimes: repeated same-structure
    value streams (pool hits), periodically drifted structures (warm
    replans), and fresh structures (cold plans)."""
    from repro_torch.sparse.structure import from_coo, random_structure

    rng = np.random.default_rng(seed)
    pool = [random_structure(n, n, density, rng) for _ in range(structures)]

    def drifted(s):
        rows, cols = s.coo()
        keep = rng.random(len(rows)) > drift
        extra = max(1, int(drift * len(rows)))
        return from_coo(
            np.concatenate([rows[keep], rng.integers(0, n, extra)]),
            np.concatenate([cols[keep], rng.integers(0, n, extra)]),
            s.shape,
        )

    for i in range(requests):
        if i and i % 16 == 0:
            pool[i % structures] = drifted(pool[i % structures])  # warm replan
        elif i and i % 24 == 0:
            pool[i % structures] = random_structure(n, n, density, rng)  # cold
        s = pool[i % structures]
        vals_a = rng.standard_normal(s.nnz).astype(np.float32)
        vals_b = rng.standard_normal(s.nnz).astype(np.float32)
        yield (s, vals_a), (s, vals_b)


def _serve_run(args):
    """The CLI's serving run on this process: (requests, report)."""
    workload = _mixed_workload(
        args.n, args.density, args.structures, args.requests, args.drift, args.seed
    )
    return serve_spgemm(
        workload,
        p=args.p,
        model=args.model,
        max_batch=args.max_batch,
        batch_window=args.window,
        seed=args.seed,
        device=args.device,
        group=getattr(args, "group", None),
    )


def _spot_check(requests) -> torch.device:
    """One product against numpy, so the smoke proves correctness, not
    just liveness; returns the result's device."""
    done = [r for r in requests if r.result is not None]
    probe = done[len(done) // 2]
    a = np.zeros(probe.a_s.shape, np.float32)
    b = np.zeros(probe.b_s.shape, np.float32)
    a[probe.a_s.coo()] = probe.a_vals
    b[probe.b_s.coo()] = probe.b_vals
    got = probe.result.cpu().numpy()
    np.testing.assert_allclose(got, a @ b, rtol=1e-4, atol=1e-4)
    return probe.result.device


def _serve_rank(group, device, args):
    """One rank of ``--ranks``: rank 0 serves and checks, returning its
    report and result device; the others follow."""
    args = argparse.Namespace(**{**vars(args), "group": group, "device": str(device)})
    requests, report = _serve_run(args)
    if report is None:
        return None
    return report, str(_spot_check(requests))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--model", default="fine")
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--density", type=float, default=0.06)
    ap.add_argument("--structures", type=int, default=3)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--drift", type=float, default=0.1)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument(
        "--ranks", action="store_true",
        help="run the plan's p ranks one a process (launch.ranks.run_ranks)",
    )
    ap.add_argument(
        "--smoke", action="store_true", help="tiny sizes for a fast in-container run"
    )
    args = ap.parse_args(argv)
    if args.smoke:
        args.n, args.requests, args.structures = 48, 24, 2

    if args.ranks:
        import tempfile

        from repro_torch.launch.ranks import run_ranks

        with tempfile.TemporaryDirectory(prefix="serve_ranks_") as workdir:
            results = run_ranks(_serve_rank, args.p, device=args.device or "cuda",
                                workdir=workdir, args=(args,))
        report, where = results[0].result
        device = torch.device(where)
        print(f"ranks: {args.p} processes over gloo")
    else:
        requests, report = _serve_run(args)
        device = _spot_check(requests)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host CPU"
    print(f"device: {device} ({name})")
    print("serve report:")
    for k, v in report.items():
        print(f"  {k}: {v}")
    print("oracle spot-check: OK")
    return report


if __name__ == "__main__":
    main()
