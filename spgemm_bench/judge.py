"""The comparison that decides ``correct``.

A request kept for the comparison (``drive.Sampler``) leaves, of each
product's dense C, a record (``Recorder``): its values at the entries of
the product's structure and its count of nonzero entries, a few MB where
the dense C takes up to 1 GB.  After the window each record is held to the
float64 reference at those entries: the number compared is the largest
error of an entry as a share of its magnitude |A| |B| (``err.<product>``).
Every entry outside the structure has to be exactly 0 (``stray.<product>``,
the nonzero count less the nonzero entries at the structure; limit 0).  The
limits are the configuration's (``limits`` in ``configs/<name>.json``), set
from the readings of the program and of the control (``control.py``) on the
card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from spgemm_bench import reference
from spgemm_bench.instance import row_of_entries


class Recorder:
    """``recorder(outputs)``: the record of each product's dense C in
    ``{product: dense C}``, on the device the C lies on; None for a C of
    the wrong shape."""

    def __init__(self, inst, device=None):
        self.structures = {p.name: inst.structures[p.name] for p in inst.products}
        self._entries: dict = {}
        if device is not None:
            for name in self.structures:
                self.entries(name, device)

    def entries(self, name: str, device) -> tuple:
        key = (name, str(device))
        if key not in self._entries:
            s = self.structures[name]
            self._entries[key] = (torch.as_tensor(row_of_entries(s), device=device),
                                  torch.as_tensor(s.indices.astype(np.int64), device=device))
        return self._entries[key]

    def __call__(self, outputs: dict) -> dict:
        records = {}
        for name, c in outputs.items():
            if tuple(c.shape) != tuple(self.structures[name].shape):
                records[name] = None
                continue
            rows, cols = self.entries(name, c.device)
            records[name] = (c[rows, cols], torch.count_nonzero(c))
        return records


def compare(record, ref, mag, structure) -> tuple[float, int]:
    """(largest error over magnitude, nonzero entries outside ``structure``)
    of one product's record against its reference ``ref`` and magnitude
    ``mag``."""
    if record is None:
        return math.inf, 0
    at, nonzero = record
    got = at.double().cpu().numpy()
    stray = int(nonzero) - int(np.count_nonzero(got))
    want = reference.aligned(ref, structure)
    scale = reference.aligned(mag, structure)
    with np.errstate(divide="ignore", invalid="ignore"):
        # an entry with no nonzero term (a value exactly 0) has to come out exact
        err = np.where(scale > 0, np.abs(got - want) / scale,
                       np.where(got == want, 0.0, math.inf))
    worst = float(err.max()) if err.size else 0.0
    return (worst if math.isfinite(worst) else math.inf), stray


def judge(inst, samples, limits: dict) -> dict:
    """The checks of a run: ``samples`` is a list of ``(base_values,
    records)`` pairs, the values as the benchmark made them (on the host)
    and the ``Recorder``'s records of the program's outputs for them.
    Returns ``{check: {"value", "limit"}}``; a run is correct when every
    value is within its limit."""
    worst = {p.name: 0.0 for p in inst.products}
    stray = {p.name: 0 for p in inst.products}
    for base_values, records in samples:
        refs = reference.products(inst, base_values)
        for name, (ref, mag) in refs.items():
            err, n = compare(records.get(name), ref, mag, inst.structures[name])
            worst[name] = max(worst[name], err)
            stray[name] += n
    checks = {}
    for name in worst:
        checks[f"err.{name}"] = {"value": worst[name], "limit": limits[name]}
        checks[f"stray.{name}"] = {"value": stray[name], "limit": 0}
    return checks


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
