"""Shared pieces of the benchmark's CPU tests: tiny sizes of each
configuration, and the card fixture of the ``gpu`` tests."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from spgemm_bench.spec import add_program_path  # noqa: E402

add_program_path(ROOT)

# tiny sizes of each generator's configurations, for the CPU
TINY = {"amg": {"n": 6}, "lp": {"rows": 120, "cols": 400, "blocks": 4}}


def tiny(spec, workload: str) -> dict:
    return TINY[spec.config(spec.workload(workload)["config"])["generator"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
