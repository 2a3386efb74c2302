"""The 95th percentile (nearest rank) of every cycle's own time on rank 0's
host clock, over the window's cycles after the traced ones, in s: on four
ranks the tail that ``cycle_p95_s`` is on one card.  Each cycle waits on the
slowest rank's host, so this tail swings too widely from run to run to hold
an end-to-end bound, and stands here beside ``cycle_s``."""

from bench_port import harness


def read(run):
    times = run.step_times[run.traced.steps:] if run.traced is not None else run.step_times
    return harness.p95(times) if times else None
