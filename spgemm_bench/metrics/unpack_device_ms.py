"""Device ms per product launched inside ``runtime.CompiledSpGEMM.unpack``
(the dense C), from the traced segment."""


def read(run):
    seg = run.segment
    if seg is None or "bench.unpack" not in seg["by_range"] or not run.segment_tally.products:
        return None
    return seg["by_range"]["bench.unpack"] / run.segment_tally.products * 1e3
