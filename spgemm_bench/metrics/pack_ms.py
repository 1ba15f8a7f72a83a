"""Host ms per product in ``api.CompiledSpGEMM.prepare`` (packing the values
into the executor's tables, and any copy from the host), over the spans'
segment of a traced run."""


def read(run):
    span = run.spans.get("bench.prepare")
    if span is None or run.span_tally is None or not run.span_tally.products:
        return None
    return span[0] / run.span_tally.products * 1e3
