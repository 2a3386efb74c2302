"""Device idle share of the traced solves, in %: 100 x (window - union of
device activity) / window, from torch.profiler."""

from bench_port import harness


def read(run):
    if run.traced is None:
        return None
    busy = harness.busy_ns(run.traced) * 1e-9
    return 100.0 * (run.traced.window_s - busy) / run.traced.window_s
