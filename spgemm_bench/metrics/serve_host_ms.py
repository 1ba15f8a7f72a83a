"""Host ms a request spends in ``SpGEMMServer.step`` outside
``SpGEMMSession.call`` (grouping, fingerprints, stacking, accounting), over
the spans' segment of a traced run: the two spans' difference per answered
request."""


def read(run):
    step = run.spans.get("bench.serve_step")
    call = run.spans.get("bench.session_call")
    if step is None or call is None or run.span_tally is None or not run.span_tally.requests:
        return None
    return (step[0] - call[0]) / run.span_tally.requests * 1e3
