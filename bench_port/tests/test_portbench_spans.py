"""The span readers (``bench_port/spanread.py`` and the metrics that use it)
on the CPU: whole traced runs of each cell at a tiny size, the four-rank
cell over gloo, with the program's CUDA events stood in for by events on
the host clock (``host_clock_events``, patched into every rank); a program
without spans (``no_spans``), which the readers must pass over; and the
readers' arithmetic on spans and a trace made by hand."""

import json
import time
from types import SimpleNamespace

import pytest
import torch

from bench_port import harness, session, spanread

SPAN_METRICS = {
    "poisson3162.gmres30": {"orth_ms_per_cycle", "matvec_ms_per_cycle", "dispatch_ms_per_cycle",
                            "launches_per_cycle", "idle_pct.cycle.dispatch"},
    "poisson3162f64.cg": {"update_ms_per_solve", "dispatch_ms_per_solve"},
}
SPAN_METRICS["poisson6324x4.gmres30"] = SPAN_METRICS["poisson3162.gmres30"]


class _HostClockEvent:
    """A timing event stamped by the host clock when it is recorded."""

    def __init__(self, device=None, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter_ns()

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e-6


def host_clock_events():
    """Patch: the program's device spans take events on the host clock."""
    torch.cuda.is_initialized = lambda: True
    torch.Event = _HostClockEvent


def no_spans():
    """Patch: a program older than the spans (its timer has no ``spans``)."""
    from lightkrylov_tpu_torch.utils import timer
    del timer.spans


def _run(bench, cell, patch, trace=True):
    line, _ = session.run_cell(cell, 2**33 + 21, 0.4, trace, device="cpu", bench=bench,
                               patch=f"bench_port.tests.test_portbench_spans:{patch}")
    return json.loads(line)


@pytest.fixture
def restore_cuda():
    saved = torch.cuda.is_initialized, torch.Event
    yield
    torch.cuda.is_initialized, torch.Event = saved
    from lightkrylov_tpu_torch.utils import timer
    timer.set_timing(False)
    timer.reset_counters()
    timer._event_pool.clear()


@pytest.mark.parametrize("cell", list(SPAN_METRICS))
def test_traced_runs_report_the_span_metrics(bench, cell, restore_cuda):
    out = _run(bench, cell, "host_clock_events")
    assert out["correct"] is True
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert SPAN_METRICS[cell] <= set(m)
    other = set().union(*SPAN_METRICS.values()) - SPAN_METRICS[cell]
    assert not other & set(m)
    assert all(m[k] >= 0 for k in SPAN_METRICS[cell])
    if "gmres" in cell:
        # the operator and the basis work both run inside every cycle
        assert m["orth_ms_per_cycle"] > 0 and m["matvec_ms_per_cycle"] > 0
        assert m["idle_pct.cycle.dispatch"] <= m["idle_pct.cycle"] + 1e-9
        assert m["host_reads_per_cycle"] == 33  # the spans change no count
        assert m["launches_per_cycle"] == 0  # no CUDA launch on the CPU
    else:
        assert m["update_ms_per_solve"] > 0 and m["dispatch_ms_per_solve"] > 0
        assert m["host_reads_per_solve"] == m["matvecs_per_solve"] + 1


def test_untraced_runs_keep_timing_off(bench, restore_cuda):
    out = _run(bench, "poisson3162.gmres30", "host_clock_events", trace=False)
    assert not set().union(*SPAN_METRICS.values()) & set(out["metrics"])
    from lightkrylov_tpu_torch.utils import timer
    assert not timer.time_lightkrylov()


@pytest.mark.parametrize("cell", ["poisson3162.gmres30", "poisson3162f64.cg"])
def test_a_program_without_spans_reports_none_of_them(bench, cell, restore_cuda):
    from lightkrylov_tpu_torch.utils import timer
    spans = timer.spans
    try:
        out = _run(bench, cell, "no_spans")
    finally:
        timer.spans = spans
    assert out["correct"] is True
    assert not SPAN_METRICS[cell] & set(out["metrics"])
    assert not timer.time_lightkrylov()  # the readers left timing off


# -- the readers' arithmetic on spans made by hand -----------------------------------


def _span(name, id_, parent, root, t0, t1, device_ms=None):
    return SimpleNamespace(name=name, id=id_, parent=parent, root=root, t0_ns=t0, t1_ns=t1,
                           device_ms=device_ms)


def _fake_run(recs, traced=None):
    timer = SimpleNamespace(spans=lambda: list(recs), time_lightkrylov=lambda: True)
    return SimpleNamespace(lt=SimpleNamespace(utils=SimpleNamespace(timer=timer)), state={},
                           traced=traced)


def _two_cycles():
    """Two cycles [0, 100] and [100, 200]: a matvec and an orth span each,
    and host reads [40, 60] and [150, 190]."""
    return [
        _span("gmres.matvec", 2, 1, 1, 5, 20, 2.0),
        _span("gmres.orth", 3, 1, 1, 20, 40, 5.0),
        _span("host_read", 4, 1, 1, 40, 60),
        _span("gmres", 1, None, 1, 0, 100, 90.0),
        _span("gmres.matvec", 6, 5, 5, 105, 120, 3.0),
        _span("gmres.orth", 7, 5, 5, 120, 150, 7.0),
        _span("host_read", 8, 5, 5, 150, 190),
        _span("gmres", 5, None, 5, 100, 200, 95.0),
    ]


def test_span_times_take_the_cycles_after_the_traced_ones():
    run = _fake_run(_two_cycles(), harness.Trace([], [], 0, 100, steps=1))
    assert spanread.device_ms_per_solve(run, "gmres", "gmres.orth") == 7.0
    assert spanread.device_ms_per_solve(run, "gmres", "gmres.matvec") == 3.0
    assert spanread.dispatch_ms_per_solve(run, "gmres") == pytest.approx(60e-6)
    run = _fake_run(_two_cycles())  # nothing traced: every cycle
    assert spanread.device_ms_per_solve(run, "gmres", "gmres.orth") == 6.0
    assert spanread.dispatch_ms_per_solve(run, "gmres") == pytest.approx(70e-6)
    assert spanread.device_ms_per_solve(run, "cg", "cg.update") is None


def test_launches_and_idle_dispatch_join_the_trace():
    # the device runs [10, 30] and [120, 200]; the host launches at 6, 22, 50 and 130
    trace = harness.Trace(device=[("k", 10, 30), ("k", 120, 200)],
                          host=[("cudaLaunchKernel", 6, 8), ("cudaMemcpyAsync", 41, 59),
                                ("cuLaunchKernel", 22, 23), ("cudaLaunchKernelExC", 50, 52),
                                ("cudaLaunchKernel", 130, 131), ("cudaLaunchKernel", 250, 251)],
                          t0_ns=0, t1_ns=200, steps=2)
    run = _fake_run(_two_cycles(), trace)
    assert spanread.launches_per_solve(run, "gmres") == 2.0  # 250 is outside both cycles
    # idle [0, 10], [30, 120]; dispatch [0, 40], [60, 100], [100, 150], [190, 200]:
    # overlap 10 + 10 + 40 + 20 = 80 ns of 200
    assert spanread.idle_dispatch_pct(run, "gmres") == pytest.approx(40.0)


def test_no_spans_no_reading():
    run = _fake_run([])
    assert spanread.solves(run, "gmres") is None
    run.lt.utils.timer = SimpleNamespace(time_lightkrylov=lambda: True)
    assert spanread.dispatch_ms_per_solve(run, "gmres") is None
    assert spanread.launches_per_solve(run, "gmres") is None
