"""Spans around the calls into each layer, and the reading of a device trace.

The spans are the benchmark's own: in a traced run (``--trace 1``) the
public entry of each layer is wrapped, from here, in a host timer and a
``torch.profiler.record_function`` range of the same name:

- ``bench.prepare``: ``api.CompiledSpGEMM.prepare`` (packing, copies in);
- ``bench.exec``: ``runtime.CompiledSpGEMM.run`` (the expands and K1);
- ``bench.unpack``: ``runtime.CompiledSpGEMM.unpack`` (the dense C);
- ``bench.serve_step``: ``launch.serve.SpGEMMServer.step``;
- ``bench.session_call``: ``distributed.session.SpGEMMSession.call``,
  synchronised at its end, so that the step's time outside it is host time.

A short segment after the measured window runs under ``torch.profiler``;
``summarize`` reads its Chrome trace: the device's busy time, each device
operation's time, and each device operation's range, found through the
launch that queued it (the runtime call with the same correlation id).
"""
from __future__ import annotations

import bisect
import functools
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host seconds and calls per span name."""

    def __init__(self):
        self.seconds: dict = defaultdict(float)
        self.calls: dict = defaultdict(int)

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name] += seconds
        self.calls[name] += 1

    def snapshot(self) -> dict:
        return {k: (self.seconds[k], self.calls[k]) for k in self.seconds}


def _wrap(owner, attr: str, name: str, spans: Spans, sync=None):
    orig = owner.__dict__[attr]

    @functools.wraps(orig)
    def timed(*args, **kwargs):
        t = time.perf_counter()
        with torch.profiler.record_function(name):
            out = orig(*args, **kwargs)
            if sync is not None:
                sync()
        spans.add(name, time.perf_counter() - t)
        return out

    setattr(owner, attr, timed)
    return lambda: setattr(owner, attr, orig)


def install(spans: Spans, sync) -> callable:
    """Wrap each layer's entry; returns the function that unwraps them."""
    from repro_torch import api
    from repro_torch.distributed import runtime, session
    from repro_torch.launch import serve

    undo = [
        _wrap(api.CompiledSpGEMM, "prepare", "bench.prepare", spans),
        _wrap(runtime.CompiledSpGEMM, "run", "bench.exec", spans),
        _wrap(runtime.CompiledSpGEMM, "unpack", "bench.unpack", spans),
        _wrap(serve.SpGEMMServer, "step", "bench.serve_step", spans),
        _wrap(session.SpGEMMSession, "call", "bench.session_call", spans, sync=sync),
    ]

    def uninstall():
        for u in reversed(undo):
            u()

    return uninstall


def profile(fn, on_card: bool) -> tuple[dict, float]:
    """Run ``fn()`` under ``torch.profiler``; returns its Chrome trace and
    the segment's length in seconds (host clock, ``fn`` ends synchronised)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        window = time.perf_counter() - t
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return data, window


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(data: dict, window_s: float) -> dict:
    """Busy seconds, seconds per device operation name and per span, and
    idle seconds by the span the host was in, from a Chrome trace."""
    events = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    launches = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    ranges = defaultdict(list)  # (pid, tid) -> [(start, end, name)]
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("bench."):
            ranges[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e["dur"], e["name"]))

    for rs in ranges.values():
        rs.sort()
    starts = {key: [r[0] for r in rs] for key, rs in ranges.items()}

    def innermost(pid, tid, ts):
        # ranges nest: the containing range that starts last is the innermost
        rs = ranges.get((pid, tid), ())
        i = bisect.bisect_right(starts.get((pid, tid), ()), ts)
        for s, end, name in reversed(rs[max(0, i - 64):i]):
            if ts <= end:
                return name
        return "outside spans"

    by_op, by_range = defaultdict(float), defaultdict(float)
    for e in device:
        sec = e["dur"] * 1e-6
        by_op[e["name"]] += sec
        launch = launches.get(e.get("args", {}).get("correlation"))
        where = innermost(launch["pid"], launch["tid"], launch["ts"]) if launch else "outside spans"
        by_range[where] += sec
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in device)
    gaps = defaultdict(float)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        labels = (innermost(pid, tid, end) for pid, tid in ranges)
        label = next((x for x in labels if x != "outside spans"), "outside spans")
        gaps[label] += (start - end) * 1e-6
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": window_s,
        "by_op": dict(by_op),
        "by_range": dict(by_range),
        "idle_by_span": dict(gaps),
    }


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
