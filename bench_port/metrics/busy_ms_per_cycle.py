"""Milliseconds of device activity (the union of kernels, copies and fills
in the profiler's trace) per traced cycle, on rank 0's card."""

from bench_port import harness


def read(run):
    if run.traced is None or not run.traced.steps:
        return None
    return 1e3 * harness.busy_ns(run.traced) * 1e-9 / run.traced.steps
