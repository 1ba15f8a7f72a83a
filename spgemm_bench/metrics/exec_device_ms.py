"""Device ms per product launched inside ``runtime.CompiledSpGEMM.run`` (the
expands and K1), from the traced segment."""


def read(run):
    seg = run.segment
    if seg is None or "bench.exec" not in seg["by_range"] or not run.segment_tally.products:
        return None
    return seg["by_range"]["bench.exec"] / run.segment_tally.products * 1e3
