"""The program's own spans (``repro_torch.tracing``), as the per-layer
metrics of its layers read them.

In a benchmark run the program's per-call spans record only while the
profiler records, that is over the traced run's profiled segment; its
set-up spans record always.  A program without the tracer, or a run in
which a span never closed, gives None: the metric is then left out.
"""
from __future__ import annotations


def total_ns(name: str) -> tuple[int, int] | None:
    """(total ns, calls) of span ``name`` over the run, or None."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    agg = tracing.snapshot()["spans"].get(name)
    if agg is None or not agg.calls:
        return None
    return agg.total_ns, agg.calls


def segment_ms(run, name: str) -> float | None:
    """Host ms of span ``name`` a product in the profiled segment."""
    span = total_ns(name)
    if span is None or run.segment_tally is None:
        return None
    products = run.segment_tally.products
    return span[0] / products * 1e-6 if products else None
