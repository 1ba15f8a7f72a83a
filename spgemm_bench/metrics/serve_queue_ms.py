"""Host ms a request waits in the server's queue, from ``submit`` to the
step that takes it into a window: the program's ``serve.queue`` span over
its records, in the profiled segment of a traced run."""
from spgemm_bench.program_spans import total_ns


def read(run):
    span = total_ns("serve.queue")
    return None if span is None else span[0] / span[1] * 1e-6
