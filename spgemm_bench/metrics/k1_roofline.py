"""K1's share of its roofline, %: the least time of the requests' local
products (``roofline.py``, from the structures) over the device time of the
kernels of ``csrc/bsr_spgemm.cu`` in the traced segment."""

K1_KERNELS = ("scalar_runs", "warp_runs", "tile_runs", "mma_runs")


def read(run):
    seg, least = run.segment, run.least_s("k1")
    if seg is None or least is None:
        return None
    k1 = sum(s for name, s in seg["by_op"].items() if any(k in name for k in K1_KERNELS))
    if k1 <= 0:
        return None
    return 100.0 * least * run.segment_tally.requests / k1
