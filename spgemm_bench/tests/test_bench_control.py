"""The control (the reference one precision down: TF32 operands, fp32 sums)
comes out not correct in every cell, and the program's own readings sit
under the limits: at a tiny size on the CPU, and on the card at a size a
test run holds (``gpu``)."""
import numpy as np
import pytest
import torch

from spgemm_bench import control, judge
from spgemm_bench.harness import Cell
from spgemm_bench.spec import Spec
from spgemm_bench.tests.conftest import tiny

SPEC = Spec()
WORKLOADS = [w["name"] for w in SPEC.data["workloads"]]
# sizes the card's test run holds: a few seconds a cell
CARD = {"amg": {"n": 21}, "lp": {"rows": 3900, "cols": 12850, "blocks": 6}}


def test_tf32_keeps_ten_mantissa_bits_rounding_to_even():
    x = np.array([1.0, 1 + 2**-11, 1 + 3 * 2**-11, 1 + 2**-10, -3.14159, 2**-130], np.float32)
    got = control.tf32(x)
    assert got.tolist()[:4] == [1.0, 1.0, 1 + 2**-9, 1 + 2**-10]
    assert got[4] == np.float32(-3.140625)
    bits = got.view(np.uint32)
    assert not (bits & 0x1FFF).any()


def _readings(cell, seed):
    program = control.program_reading(cell, seed, 0.3)
    ctl = control.control_reading(cell, seed + 1)
    return program, ctl


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_and_the_program_passes_on_the_cpu(workload):
    cell = Cell(workload, torch.device("cpu"), SPEC, tiny(SPEC, workload))
    program, ctl = _readings(cell, 21)
    assert program["compared"] > 0 and judge.passed(program["checks"])
    assert not judge.passed(ctl["checks"])


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_and_the_program_passes_on_the_card(workload, card):
    cell = Cell(workload, card, SPEC, CARD[SPEC.config(
        SPEC.workload(workload)["config"])["generator"]])
    for seed in (41, 43, 45):
        program, ctl = _readings(cell, seed)
        assert program["compared"] > 0 and judge.passed(program["checks"])
        assert not judge.passed(ctl["checks"])
