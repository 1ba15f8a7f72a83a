"""The one traffic driver: a mix is a data file, ``traffic/<name>.json``.

Keys of a mix:

- ``driver``: ``"loop"``, a closed loop of one client through one unbatched
  ``compile()`` handle a product, each request synchronised before the next;
  or ``"serve"``, a closed loop of ``clients`` through
  ``launch.serve.SpGEMMServer`` (``max_batch``, ``batch_window``,
  ``queue_limit``), each client resubmitting as its answer comes;
- ``pool``: value sets made from the seed in set-up (on the card for
  ``loop``; on the host, as a client sends them, for ``serve``); requests
  draw them in a seeded order;
- ``sample``: requests of the window kept for the comparison (a reservoir
  drawn from the seed);
- ``warmup`` and ``trace``: requests (``loop``) or server steps (``serve``)
  run before the window, and, in a traced run, in each of the two segments
  after it (the spans', then the profiler's).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

SEED_MASK = (1 << 64) - 1


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & SEED_MASK, stream])


def synchronizer(device: torch.device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


class Order:
    """Pool indices in a seeded order, one per request."""

    def __init__(self, seed: int, pool: int):
        self._idx = rng(seed, 1).integers(0, pool, size=1 << 16)
        self._n = 0

    def next(self) -> int:
        k = int(self._idx[self._n % len(self._idx)])
        self._n += 1
        return k


class Sampler:
    """A reservoir of ``k`` requests: each request offered has the same
    chance to be kept, drawn from the seed.  It holds ``record(outputs())``
    of a request it keeps (``judge.Recorder``: a few MB, not the dense C's);
    ``outputs()`` is called only for such a request."""

    def __init__(self, k: int, seed: int, record):
        self.k, self.kept, self.seen = k, [], 0
        self._rng = rng(seed, 2)
        self._record = record

    def offer(self, key: int, outputs) -> None:
        if len(self.kept) < self.k:
            self.kept.append((key, self._record(outputs())))
        else:
            j = int(self._rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = (key, self._record(outputs()))
        self.seen += 1


@dataclasses.dataclass
class Tally:
    latencies: list = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    requests: int = 0  # answered
    products: int = 0


def _plan_args(cfg: dict) -> dict:
    return {"p": cfg["p"], "model": cfg["model"], "eps": cfg["eps"],
            "seed": cfg["plan_seed"], "engine": cfg["engine"]}


class LoopDriver:
    """One client: each request runs the configuration's products in order
    through their own handles, a chained operand read from the dense result
    it depends on at that product's structure, then synchronises."""

    host_values = False

    def __init__(self, inst, cfg: dict, traffic: dict, device: torch.device):
        import repro_torch

        self.inst, self.device = inst, device
        self.sync = synchronizer(device)
        s = inst.structures
        t = time.perf_counter()
        self.handles = {
            p.name: repro_torch.plan(s[p.a], s[p.b], **_plan_args(cfg)).compile(device=device)
            for p in inst.products
        }
        self.plan_s = time.perf_counter() - t
        self.reads = {}
        for name in {op for p in inst.products for op in (p.a, p.b) if inst.chained(op)}:
            c = s[name].tocoo()
            self.reads[name] = (torch.as_tensor(c.row.astype(np.int64), device=device),
                                torch.as_tensor(c.col.astype(np.int64), device=device))

    def comms(self) -> list:
        return [h.runtime.comm for h in self.handles.values()]

    def batch_stats(self):
        return None

    def _operand(self, name: str, values: dict, outputs: dict):
        if name in self.reads:
            rows, cols = self.reads[name]
            return outputs[name][rows, cols]
        return values[name]

    def request(self, values: dict) -> dict:
        outputs = {}
        for p in self.inst.products:
            a = self._operand(p.a, values, outputs)
            b = self._operand(p.b, values, outputs)
            outputs[p.name] = self.handles[p.name](a, b)
        return outputs

    def run(self, pool, order, tally: Tally, sampler=None, count=None, deadline=None):
        n = 0
        while (count is None or n < count) and (deadline is None or time.perf_counter() < deadline):
            k = order.next()
            tally.attempted += 1
            t = time.perf_counter()
            outputs = self.request(pool[k])
            self.sync()
            tally.latencies.append(time.perf_counter() - t)
            tally.requests += 1
            tally.products += len(outputs)
            if sampler is not None:
                sampler.offer(k, lambda: outputs)
            outputs = None  # the answer goes with its request: nothing holds it past here
            n += 1


class ServeDriver:
    """``clients`` closed-loop clients of one ``SpGEMMServer``: all submit,
    the server steps, each answered client submits its next request."""

    host_values = True

    def __init__(self, inst, cfg: dict, traffic: dict, device: torch.device):
        from repro_torch.launch.serve import ServeConfig, SpGEMMServer
        from repro_torch.sparse.structure import SparseStructure

        if len(inst.products) != 1 or inst.chained(inst.products[0].b):
            raise ValueError("the serving driver serves one product of base operands")
        self.product = prod = inst.products[0]
        self.clients = traffic["clients"]
        self.max_batch = traffic["max_batch"]
        self.device = device
        self.server = SpGEMMServer(ServeConfig(
            **_plan_args(cfg), max_batch=traffic["max_batch"],
            batch_window=traffic["batch_window"], queue_limit=traffic["queue_limit"],
            device=str(device),
        ))
        s = inst.structures
        self.operands = (SparseStructure.wrap(s[prod.a]), SparseStructure.wrap(s[prod.b]))
        t = time.perf_counter()
        self.entry = self.server.session.entry_for(*self.operands)  # plans and compiles
        self.plan_s = time.perf_counter() - t

    def comms(self) -> list:
        batched = self.entry.planned.compile(batch=self.max_batch, device=self.device)
        return [self.entry.exe.runtime.comm, batched.runtime.comm]

    def batch_stats(self):
        st = self.server.stats
        return st.batch_items, st.batch_slots

    def run(self, pool, order, tally: Tally, sampler=None, count=None, deadline=None):
        """``count``: server steps to run; ``deadline``: no submission after it."""
        server, prod = self.server, self.product
        a_s, b_s = self.operands

        def submit():
            k = order.next()
            vals = pool[k]
            tally.attempted += 1
            return k, server.submit((a_s, vals[prod.a]), (b_s, vals[prod.b]))

        pending = [submit() for _ in range(self.clients)]
        steps = 0
        while pending:
            server.step()
            steps += 1
            stop = (count is not None and steps >= count) or (
                deadline is not None and time.perf_counter() >= deadline)
            waiting = []
            for k, req in pending:
                if not req.done:
                    waiting.append((k, req))
                    continue
                if req.error is not None:
                    tally.failed += 1
                else:
                    tally.latencies.append(req.latency_s)
                    tally.requests += 1
                    tally.products += 1
                    if sampler is not None:
                        sampler.offer(k, lambda: {prod.name: req.result})
                if not stop:
                    waiting.append(submit())
            # the answers go with their requests: nothing holds a batch's C past here
            pending, req = waiting, None


DRIVERS = {"loop": LoopDriver, "serve": ServeDriver}


def make_pool(generator, cfg: dict, inst, traffic: dict, seed: int, device, host: bool) -> list:
    """The mix's value sets, made on ``device`` from the seed (copied to the
    host where clients send host values)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & SEED_MASK)
    pool = generator.values(cfg, inst, traffic["pool"], gen, device)
    if host:
        pool = [{k: v.cpu().numpy() for k, v in entry.items()} for entry in pool]
    return pool


def host_copy(values: dict) -> dict:
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in values.items()}
