"""One run of one cell: set-up, warm-up, the measured window, the traced
segments, the comparison, and the result line.

``run_cell`` does all of it on any device; ``run.py`` refuses to call it
without a card.  Set-up is everything from the process's start to the
window: the structures from the configuration's generator, planning and
compiling (the nvcc build on a checkout's first run), the value pool and the
warm-up of the mix's own shapes.

The window runs the program as it stands, traced run or not.  A traced run
then wraps each layer's entry in the benchmark's spans (``trace.py``) for a
segment of ``trace`` requests or steps, and runs as many again under the
profiler: the spans and the device trace are read there, the window's
rates stay those of the bare program.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import torch

from spgemm_bench import drive, judge, roofline, trace
from spgemm_bench.spec import Spec


@dataclasses.dataclass
class RunInfo:
    """What a metric's reader reads (``metrics/<name>.py``)."""

    workload: str
    kind: str  # the card's name, or "cpu"
    counts: dict  # product -> roofline.Counts
    setup_s: float
    plan_s: float
    window_s: float
    tally: drive.Tally
    spans: dict  # span -> (host seconds, calls), over the spans' segment
    span_tally: drive.Tally | None
    moved_items: int  # Loopback.items_moved over the window
    batch: tuple | None  # (items, slots) the server dispatched in the window
    memory_peak_bytes: int
    segment: dict | None = None  # trace.summarize of the traced segment
    segment_tally: drive.Tally | None = None

    def least_s(self, what: str) -> float | None:
        """The least time of one request's products on this card: ``what``
        is ``"k1"`` (the local products) or ``"product"`` (dense C too)."""
        total = 0.0
        for c in self.counts.values():
            t = roofline.least_seconds(c.flops, c.k1_bytes if what == "k1" else c.product_bytes,
                                       self.kind)
            if t is None:
                return None
            total += t
        return total


class Cell:
    """One cell set up: its configuration, mix, structures and driver (the
    program planned and compiled).  ``values(seed)`` makes a value pool."""

    def __init__(self, workload: str, device: torch.device, spec: Spec | None = None,
                 override: dict | None = None):
        self.spec = spec = spec or Spec()
        w = spec.workload(workload)
        self.cfg = {**spec.config(w["config"]), **(override or {})}
        self.traffic = spec.traffic(w["traffic"])
        self.generator = spec.generator(self.cfg["generator"])
        self.device = device
        self.inst = self.generator.build(self.cfg)
        self.driver = drive.DRIVERS[self.traffic["driver"]](self.inst, self.cfg, self.traffic,
                                                            device)
        self.recorder = judge.Recorder(self.inst, device)

    def sampler(self, seed: int) -> drive.Sampler:
        return drive.Sampler(self.traffic["sample"], seed, self.recorder)

    def values(self, seed: int) -> tuple:
        """The pool made from ``seed`` and its seeded order."""
        pool = drive.make_pool(self.generator, self.cfg, self.inst, self.traffic, seed,
                               self.device, self.driver.host_values)
        return pool, drive.Order(seed, len(pool))

    def warm_up(self, pool, order, seed: int) -> None:
        """The mix's own path, the sample's records with it."""
        self.driver.run(pool, order, drive.Tally(), self.sampler(seed),
                        count=self.traffic["warmup"])


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device: torch.device,
             t0: float, spec: Spec | None = None, override: dict | None = None) -> dict:
    """Run ``workload`` once; returns the result line's object."""
    cell = Cell(workload, device, spec, override)
    spec, cfg, traffic, inst, driver = cell.spec, cell.cfg, cell.traffic, cell.inst, cell.driver
    sync = drive.synchronizer(device)
    on_card = device.type == "cuda"
    pool, order = cell.values(seed)
    cell.warm_up(pool, order, seed)
    comms = driver.comms()
    for c in comms:
        c.reset()
    batch0 = driver.batch_stats()
    sampler = cell.sampler(seed)
    tally = drive.Tally()
    sync()
    start = time.perf_counter()
    driver.run(pool, order, tally, sampler, deadline=start + seconds)
    sync()
    window_s = time.perf_counter() - start
    moved = sum(c.items_moved for c in comms)
    batch = driver.batch_stats()
    if batch is not None:
        batch = (batch[0] - batch0[0], batch[1] - batch0[1])
    window_spans, span_tally, segment, segment_tally = {}, None, None, None
    if traced:
        spans = trace.Spans()
        uninstall = trace.install(spans, sync)
        try:
            span_tally = drive.Tally()
            driver.run(pool, order, span_tally, count=traffic["trace"])
            sync()
            window_spans = spans.snapshot()
            segment_tally = drive.Tally()
            data, seg_s = trace.profile(
                lambda: driver.run(pool, order, segment_tally, count=traffic["trace"]), on_card)
            segment = trace.summarize(data, seg_s)
            del data
        finally:
            uninstall()
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    info = RunInfo(
        workload=workload,
        kind=torch.cuda.get_device_name(device) if on_card else "cpu",
        counts=roofline.instance_counts(inst),
        setup_s=start - t0,
        plan_s=driver.plan_s,
        window_s=window_s,
        tally=tally,
        spans=window_spans,
        span_tally=span_tally,
        moved_items=moved,
        batch=batch,
        memory_peak_bytes=peak,
        segment=segment,
        segment_tally=segment_tally,
    )

    # the program's state goes before the reference runs; the sampled
    # outputs stay, to be judged
    samples = [(drive.host_copy(pool[k]), outputs) for k, outputs in sampler.kept]
    del cell, driver, pool, comms, sampler
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = judge.judge(inst, samples, cfg["limits"])
    checks["failed"] = {"value": tally.failed, "limit": 0}
    compared = len(samples)
    correct = compared > 0 and judge.passed(checks)
    del samples

    metrics = {}
    for m in spec.metrics(workload, per_layer=traced):
        value = spec.reader(m["name"]).read(info)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": info.kind,
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": tally.attempted, "failed": tally.failed,
              "metrics": metrics, "device": device_info}
    if segment is not None:
        device_info["busy_s"] = segment["busy_s"]
        device_info["window_s"] = segment["window_s"]
        result["breakdown"] = {"device_ops": trace.top(segment["by_op"]),
                               "idle_gaps": trace.top(segment["idle_by_span"])}
    result["compared"] = compared
    result["checks"] = checks
    return result
