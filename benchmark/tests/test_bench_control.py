"""The control of each cell comes out as not correct: the reference put in
the program's place in the next lower precision (TF32 for float32 with TF32
off, int4 for int8, bfloat16 for the CRF's float32) fails at least one of
the cell's numbers against its limit, at the cell's own size, on three
seeds. Needs the card: ``python -m pytest benchmark/tests -m cuda``."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.tests.test_bench_files import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = harness.load_cell(name)
    drv = harness.driver(cell["driver"])
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        numbers = drv.limit_readings(harness.Run(cell, seed, 0.0, False, "cuda"), "control")
        failed = [k for k, v in numbers.items() if k in cell["limits"]
                  and v > cell["limits"][k]]
        assert failed, f"seed {seed}: the control passed every limit: {numbers}"
