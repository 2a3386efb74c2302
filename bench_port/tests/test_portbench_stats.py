"""The metric arithmetic: whole-window rates, the 95th percentile over every
step, and the reduction of a profiler trace to busy time, idle gaps and
device operations, on synthetic traces."""

import math
import statistics

import pytest

from bench_port import harness


def test_per_step_is_the_whole_window_over_the_steps():
    assert harness.per_step(10.0, 4) == 2.5
    assert harness.statistic("per_step", [1.0, 2.0, 3.0, 4.0], 12.0) == 3.0
    with pytest.raises(harness.BenchError):
        harness.per_step(1.0, 0)


def test_p95_is_the_nearest_rank_over_every_sample():
    xs = list(range(1, 201))  # 200 samples: the 190th is the 95th percentile
    assert harness.p95(xs) == 190
    assert harness.p95([5.0]) == 5.0
    shuffled = xs[::-1]
    assert harness.statistic("p95", shuffled, 0.0) == 190
    # within one sample of the exclusive-method quantile
    assert abs(harness.p95(xs) - statistics.quantiles(xs, n=20)[18]) <= 1


def _trace(device, host=(), t0=0, t1=100):
    return harness.Trace(device=list(device), host=list(host), t0_ns=t0, t1_ns=t1)


def test_busy_time_is_the_union_of_device_activity_in_the_window():
    tr = _trace([("a", 10, 20), ("b", 15, 30), ("c", 40, 50), ("d", 95, 120), ("e", -5, 2)])
    # [10, 30] + [40, 50] + [95, 100] + [0, 2]
    assert harness.busy_ns(tr) == 20 + 10 + 5 + 2
    assert harness.idle_gaps(tr) == [(2, 10), (30, 40), (50, 95)]
    idle_pct = 100.0 * (tr.t1_ns - tr.t0_ns - harness.busy_ns(tr)) / (tr.t1_ns - tr.t0_ns)
    assert math.isclose(idle_pct, 63.0)


def test_an_empty_device_leaves_the_whole_window_idle():
    tr = _trace([])
    assert harness.busy_ns(tr) == 0
    assert harness.idle_gaps(tr) == [(0, 100)]


def test_idle_gaps_are_named_by_the_innermost_host_operation():
    device = [("k", 0, 10), ("k", 20, 30), ("k", 60, 70), ("k", 90, 100)]
    host = [("step", 5, 95), ("sync", 12, 28), ("launch", 40, 55)]
    # gaps: (10, 20) mid 15 in sync; (30, 60) mid 45 in launch; (70, 90) mid 80 in step
    got = dict(harness.gaps_by_host(_trace(device, host)))
    assert got == pytest.approx({"sync": 10e-9, "launch": 30e-9, "step": 20e-9})
    # no host operation at all: the host was in Python
    [[name, seconds]] = harness.gaps_by_host(_trace(device))
    assert name == "python" and seconds == pytest.approx(60e-9)


def test_device_ops_sum_time_by_name_in_the_window():
    tr = _trace([("gemm", 0, 30), ("add", 30, 35), ("gemm", 50, 60), ("add", 98, 110)])
    got = harness.device_ops(tr)
    assert [n for n, _ in got] == ["gemm", "add"]
    assert [s for _, s in got] == pytest.approx([40e-9, 7e-9])
    assert len(harness.device_ops(_trace([(f"k{i}", i, i + 1) for i in range(20)]))) == 10


def test_checks_pass_only_within_their_limits_and_finite():
    assert harness.checks_ok({"a": harness.check_entry(1e-5, 1e-4)})
    assert not harness.checks_ok({"a": harness.check_entry(2e-4, 1e-4)})
    assert not harness.checks_ok({"a": harness.check_entry(float("nan"), 1e-4)})


def test_the_sharded_tail_reads_the_untraced_cycles_alone():
    from types import SimpleNamespace

    reader = harness.load_module("metrics", "cycle_p95_s.sharded")
    times = [9.0] * 3 + [float(t) for t in range(1, 201)]  # 3 traced cycles, stretched
    traced = SimpleNamespace(steps=3)
    assert reader.read(SimpleNamespace(step_times=times, traced=traced)) == 190
    assert reader.read(SimpleNamespace(step_times=times[3:], traced=None)) == 190
    # a window that the trace covered whole leaves nothing to read
    assert reader.read(SimpleNamespace(step_times=[9.0] * 3, traced=traced)) is None
