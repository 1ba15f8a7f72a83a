"""The 95th percentile of every answered request's latency in the window, ms:
the serving driver's from ``submit`` to the server's ``t_done``, the loop
driver's from the call to its result synchronised on the card."""
import numpy as np


def read(run):
    lat = run.tally.latencies
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
