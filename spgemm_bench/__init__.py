"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 spgemm_bench/run.py --workload amg27-n42.galerkin --seed 7 --seconds 10 --trace 0

and prints one JSON line.  Everything a cell is made of is found by name:
``configs/<config>.json`` (sizes, the generator that builds the structures,
the comparison's limits), ``generators/<generator>.py`` (frozen structure
generators and value makers), ``traffic/<traffic>.json`` (a mix read by the
one driver in ``drive.py``) and ``metrics/<metric>.py`` (a reader of one
per-layer metric).  The yardstick (the float64 reference, the comparison, the
roofline counts and the table of peaks) lives here and imports nothing of the
program.
"""
