"""Test-support machinery that ships with the library.

``repro_torch.testing.faults`` is the fault-injection harness: production
code exposes named patch points (``faults.fire("partition")`` etc.) and
tests script failures at those boundaries without monkeypatching internals.
"""
from repro_torch.testing import faults

__all__ = ["faults"]
