"""The control, the reference one precision below the configuration's put
in the program's place, comes out not correct under each cell's limits:
on the CPU at a tiny size, and on the card at the cell's own size."""

import pytest
import torch

from bench_port import control, harness
from bench_port.tests.conftest import full_bench

CELLS = ["poisson3162.gmres30", "poisson3162f64.cg", "poisson6324x4.gmres30"]
#: the precision below each configuration's: TF32 for float32 with TF32 off,
#: float32 for float64
CONTROL = {"poisson3162.gmres30": "tf32", "poisson3162f64.cg": "float32",
           "poisson6324x4.gmres30": "tf32"}
STATED = {"poisson3162.gmres30": "float32", "poisson3162f64.cg": "float64",
          "poisson6324x4.gmres30": "float32"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_reference_passes_on_the_cpu(bench, cell):
    low = control.control_checks(cell, 2**33 + 21, CONTROL[cell], "cpu", bench)
    assert not harness.checks_ok(low)
    same = control.control_checks(cell, 2**33 + 21, STATED[cell], "cpu", bench)
    assert harness.checks_ok(same)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_own_size_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        assert not harness.checks_ok(control.control_checks(cell, seed, CONTROL[cell],
                                                            bench=full_bench()))
