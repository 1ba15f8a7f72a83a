"""Host seconds the partitioner took in set-up: the program's
``plan.partition`` span, which records in every run."""
from spgemm_bench.program_spans import total_ns


def read(run):
    span = total_ns("plan.partition")
    return None if span is None else span[0] * 1e-9
