"""The comparison with the reference catches a broken timed path: with each
fault a cell can have planted under the window, ``correct`` comes out
false (CPU, tiny sizes, every other part of a run as it is)."""

import json

import pytest

from bench_port import session
from bench_port.tests import faults

FAULTS = [
    ("poisson3162.gmres30", "gmres_state_unchanged"),
    ("poisson3162.gmres30", "gmres_answer_altered"),
    ("poisson3162f64.cg", "cg_state_unchanged"),
    ("poisson3162f64.cg", "cg_answer_altered"),
    ("poisson6324x4.gmres30", "gmres_state_unchanged"),
    ("poisson6324x4.gmres30", "gmres_answer_altered"),
    ("poisson6324x4.gmres30", "halo_left_out"),
    ("poisson6324x4.gmres30", "allreduce_left_out"),
]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_makes_the_run_incorrect(bench, cell, fault):
    try:
        line, _ = session.run_cell(cell, 2**33 + 9, 0.2, False, device="cpu", bench=bench,
                                   patch=f"bench_port.tests.faults:{fault}")
    finally:
        faults.restore()
    out = json.loads(line)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
