"""Host ms per product copying the operands' values to the executor's
device and dtype (from the host in a serving cell; a no-op for values
already on the card): the program's ``runtime.copy_in`` span, in the
profiled segment of a traced run."""
from spgemm_bench.program_spans import segment_ms


def read(run):
    return segment_ms(run, "runtime.copy_in")
