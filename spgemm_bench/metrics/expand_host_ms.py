"""Host ms per product in the executor's expands (the gather, the exchange
and the slot tables of each operand): the program's ``exec.expand`` span,
in the profiled segment of a traced run."""
from spgemm_bench.program_spans import segment_ms


def read(run):
    return segment_ms(run, "exec.expand")
