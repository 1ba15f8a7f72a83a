"""Host ms per product in K1's wrapper (``bsr_spgemm_local``: checks,
casts, C's allocation, the launch): the program's ``k1.launch`` span, in
the profiled segment of a traced run."""
from spgemm_bench.program_spans import segment_ms


def read(run):
    return segment_ms(run, "k1.launch")
