"""The cell ``convdiff3162f64.gmres30`` on the CPU at a tiny size: a whole
run is ``correct``; each fault planted under the timed path turns it
false; a program that cannot build the layout on the card is refused at
set-up; its readers report only what the program gives them; and its
reference imports nothing of the program, of JAX or of scipy."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import scipy.sparse as sp
import torch

import lightkrylov_tpu_torch as lt
from bench_port import harness, session
from bench_port.tests import faults
from bench_port.tests.conftest import tiny_bench
from lightkrylov_tpu_torch.ops import gmres as fused

CELL = "convdiff3162f64.gmres30"
#: neither a multiple of the default block's 8 rows nor of its 128 columns
TINY = {"nx": 40, "ny": 24}
SPAN_READERS = {"spmv_ms_per_cycle", "spmv_gnnz_per_s"}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    b = tiny_bench(tmp_path_factory.mktemp("configs"))
    for c in b["configs"]:
        if c["name"] == "convdiff2d_3162_f64_bell":
            cfg = json.loads(Path(c["file"]).read_text())
            cfg.update(TINY)
            Path(c["file"]).write_text(json.dumps(cfg))
    return b


def _run(bench, patch=None, trace=False, module="test_portbench_convdiff"):
    try:
        line, _ = session.run_cell(CELL, 2**33 + 41, 0.3, trace, device="cpu", bench=bench,
                                   patch=patch and f"bench_port.tests.{module}:{patch}")
    finally:
        faults.restore()
    return json.loads(line)


# -- faults, patched into the program by name ------------------------------------


def transposed_operator():
    """The transposed product in the operator's place."""
    faults._set(lt.BellOperator, "matvec", lt.BellOperator.rmatvec)


def convection_dropped():
    """The matrix handed over without its convection term: its symmetric
    part, the diffusion alone."""
    original = lt.bell_from_scipy
    faults._set(lt, "bell_from_scipy", lambda A, *a, **k: original(0.5 * (A + A.T), *a, **k))


def one_gram_schmidt_pass():
    """Each new direction left unprojected at its own step (the rank-2
    update's second column zeroed), so the next step's delayed pass is the
    only one.  Leaving out the delayed pass instead (CGS1) moves the float64
    iterate by about 1e-15 on this operator, under any limit a reading can
    set."""
    original = fused.dcgs2_update_reference

    def one_pass(V, k, w, C, inv_gamma):
        C = C.clone()
        C[:, 1] = 0
        original(V, k, w, C, inv_gamma)
    faults._set(fused, "dcgs2_update_reference", one_pass)


def host_assembly_only():
    """A program older than the assembly on the card."""
    from lightkrylov_tpu_torch.ops import spmv
    faults._set(spmv, "bell_assemble_torch", None)
    delattr(spmv, "bell_assemble_torch")


# -- the tests ---------------------------------------------------------------------


def test_a_tiny_run_is_correct(bench):
    out = _run(bench)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"cycle_s", "cycle_p95_s", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("fault", ["transposed_operator", "convection_dropped",
                                   "one_gram_schmidt_pass"])
def test_a_planted_fault_makes_the_run_incorrect(bench, fault):
    out = _run(bench, fault)
    assert out["correct"] is False
    assert any(not c["value"] <= c["limit"] for c in out["checks"].values())


def test_a_program_without_the_card_assembly_is_refused(bench):
    with pytest.raises(harness.BenchError, match="on the host only"):
        _run(bench, "host_assembly_only")
    from lightkrylov_tpu_torch.ops import spmv
    assert callable(spmv.bell_assemble_torch)


@pytest.fixture
def restore_cuda():
    saved = torch.cuda.is_initialized, torch.Event
    yield
    torch.cuda.is_initialized, torch.Event = saved
    from lightkrylov_tpu_torch.utils import timer
    timer.set_timing(False)
    timer.reset_counters()
    timer._event_pool.clear()


def test_a_traced_run_reports_the_operator_readers(bench, restore_cuda):
    out = _run(bench, "host_clock_events", trace=True, module="test_portbench_spans")
    assert out["correct"] is True
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert SPAN_READERS <= set(m) and m["spmv_ms_per_cycle"] > 0 and m["spmv_gnnz_per_s"] > 0
    # every application goes through the product: one span a matvec, 32 a cycle
    assert m["host_reads_per_cycle"] == 33
    assert m["matvec_ms_per_cycle"] >= m["spmv_ms_per_cycle"]
    assert "bell_spmv_roofline" not in m  # a time of the card only


def test_readers_give_nothing_without_spans(bench, restore_cuda):
    from lightkrylov_tpu_torch.utils import timer
    spans = timer.spans
    try:
        out = _run(bench, "no_spans", trace=True, module="test_portbench_spans")
    finally:
        timer.spans = spans
    assert out["correct"] is True
    assert not SPAN_READERS & set(out["metrics"])
    out = _run(bench, "host_clock_events", trace=False, module="test_portbench_spans")
    assert not SPAN_READERS & set(out["metrics"])
    assert not timer.time_lightkrylov()


def test_product_bytes_count_the_layout_as_it_stands():
    roofline = harness.load_module("metrics", "bell_spmv_roofline")
    bell = lt.bell_from_scipy(sp.eye(300, 250, format="csr"), dtype=torch.float64,
                              device="cpu")
    nbr, K, bm, bn = bell.data.shape
    want = nbr * K * bm * bn * 8 + nbr * K * 4 + 256 * 8 + nbr * bm * 8
    assert roofline.product_bytes(bell.data, bell.cols, 250) == want
    assert roofline.read(type("R", (), {"state": {}})()) is None


def test_the_reference_imports_no_program_jax_or_scipy():
    code = ("import sys, bench_port.reference.convdiff\n"
            "print(' '.join(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(harness.ROOT)})
    tops = {m.split(".", 1)[0] for m in out.stdout.split()}
    assert "torch" in tops
    assert not tops & ({"lightkrylov_tpu_torch", "scipy"} | set(harness.FORBIDDEN_MODULES))
