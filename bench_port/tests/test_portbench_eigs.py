"""The ``eigs`` cell (``poisson3162.eigs16``, loop ``eigs_calls``) on the CPU
at a tiny size: whole runs are correct untraced and traced, the traced run
reads the new span metrics, a program without the spans reads none of them,
and each fault planted under the timed path (a restart that skips the basis
rotation, CGS2 with its second pass left out, the start vector returned as
the eigenvectors) turns ``correct`` false.  The reference imports nothing of
the program."""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_port import control, harness, session
from bench_port.tests.conftest import full_bench

ROOT = Path(__file__).resolve().parents[2]
CELL = "poisson3162.eigs16"
CONFIG = "poisson2d_3162_f32_eigs16"
#: the cell cut for a CPU run: a 24 x 20 grid, 4 pairs from a basis of 16
TINY = {"nx": 24, "ny": 20, "nev": 4, "kdim": 16}
SPAN_METRICS = {"check_ms_per_solve", "restart_ms_per_solve", "arnoldi_orth_ms_per_solve"}
SEED = 2**33 + 17


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    bench = full_bench()
    for c in bench["configs"]:
        if c["name"] == CONFIG:
            cfg = json.loads(Path(c["file"]).read_text())
            cfg.update(TINY)
            path = tmp_path_factory.mktemp("eigs") / f"{CONFIG}.json"
            path.write_text(json.dumps(cfg))
            c["file"] = str(path)
    return bench


@pytest.fixture
def restore():
    saved = torch.cuda.is_initialized, torch.Event
    yield
    torch.cuda.is_initialized, torch.Event = saved
    _saved_undo()
    from lightkrylov_tpu_torch.utils import timer
    timer.set_timing(False)
    timer.reset_counters()
    timer._event_pool.clear()


def _run(bench, trace=False, patch=None):
    """A whole run of the tiny cell, ``patch`` (``module:function``) applied."""
    line, _ = session.run_cell(CELL, SEED, 0.2, trace, device="cpu", bench=bench, patch=patch)
    return json.loads(line)


SPANS = "bench_port.tests.test_portbench_spans"
FAULTS = "bench_port.tests.test_portbench_eigs"


def test_untraced_run_is_correct_and_reports_its_end_to_end_metrics(bench, restore):
    out = _run(bench)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"solve_s", "setup_s"}
    assert set(out["checks"]) == set(harness.find_cell(CELL, bench).limits)
    assert {"ritz_gap", "residual_gap", "matvec_gap"} <= set(out["checks"])


def test_traced_run_reads_the_eigs_spans(bench, restore):
    out = _run(bench, trace=True, patch=f"{SPANS}:host_clock_events")
    assert out["correct"] is True
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert SPAN_METRICS <= set(m) and all(m[k] > 0 for k in SPAN_METRICS)
    # 16 steps, then 8 a restart for 19 restarts: tolerance 0 runs every cycle
    assert m["matvecs_per_solve"] == 16 + 19 * 8
    assert m["host_reads_per_solve"] > m["matvecs_per_solve"]


def test_a_program_without_spans_reports_none_of_them(bench, restore):
    from lightkrylov_tpu_torch.utils import timer
    spans = timer.spans
    try:
        out = _run(bench, trace=True, patch=f"{SPANS}:no_spans")
    finally:
        timer.spans = spans
    assert out["correct"] is True
    assert not SPAN_METRICS & set(out["metrics"])
    assert "matvecs_per_solve" in out["metrics"]


# -- planted faults ---------------------------------------------------------------

_undo = []


def _saved_undo():
    while _undo:
        owner, name, value = _undo.pop()
        setattr(owner, name, value)


def _set(owner, name, value):
    _undo.append((owner, name, getattr(owner, name)))
    setattr(owner, name, value)


def rotation_skipped():
    """The IRAM restart keeps the old leading columns where it should rotate
    them by the filter's transform (its ``H`` and residual as computed)."""
    eigs_mod = importlib.import_module("lightkrylov_tpu_torch.solvers.eigs")
    original = eigs_mod.iram_restart

    def iram_restart(X, H, n_target):
        X_new, H_new, n, ok = original(X, H, n_target)
        kept = torch.arange(X.shape[0], device=X.device).reshape(-1, 1, 1) < n
        return torch.where(kept, X, X_new), H_new, n, ok
    _set(eigs_mod, "iram_restart", iram_restart)


def cgs_single_pass():
    """The Arnoldi step's Gram-Schmidt projection applied once, not twice."""
    arnoldi = importlib.import_module("lightkrylov_tpu_torch.krylov.arnoldi")
    from lightkrylov_tpu_torch.krylov.gram_schmidt import orthogonalize_against_basis
    _set(arnoldi, "double_gram_schmidt_step", orthogonalize_against_basis)


def start_as_eigenvectors():
    """Every returned eigenvector is the start vector."""
    import lightkrylov_tpu_torch as lt
    original = lt.eigs

    def eigs(A, nev, x0=None, **kwargs):
        w, vecs, res, info, meta = original(A, nev, x0=x0, **kwargs)
        v = (x0 / torch.linalg.vector_norm(x0)).to(vecs.dtype)
        return w, torch.stack([v] * len(w)), res, info, meta
    _set(lt, "eigs", eigs)


@pytest.mark.parametrize("fault", ["rotation_skipped", "cgs_single_pass",
                                   "start_as_eigenvectors"])
def test_a_planted_fault_makes_the_run_incorrect(bench, restore, fault):
    out = _run(bench, patch=f"{FAULTS}:{fault}")
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_control_fails_and_the_reference_passes_on_the_cpu(bench):
    assert not harness.checks_ok(control.control_checks(CELL, SEED, "tf32", "cpu", bench))
    assert harness.checks_ok(control.control_checks(CELL, SEED, "float32", "cpu", bench))


def test_the_eigs_reference_imports_nothing_of_the_program():
    code = ("import bench_port.reference.eigs, sys\n"
            "print(' '.join(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    tops = {m.split(".", 1)[0] for m in out.stdout.split()}
    assert not tops & ({"lightkrylov_tpu_torch"} | set(harness.FORBIDDEN_MODULES))


@pytest.mark.cuda
def test_control_fails_at_the_cells_own_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    for seed in (2**31 + 101, 2**31 + 102):
        assert not harness.checks_ok(control.control_checks(CELL, seed, "tf32",
                                                            bench=full_bench()))
