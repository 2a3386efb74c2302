"""Reading the program's spans (``lightkrylov_tpu_torch.utils.timer``) for
the per-layer metrics.

A reader turns the program's timing on in its ``measure`` (:func:`enable`),
which the harness calls in traced runs only, before the window; untraced
runs keep timing off.  The harness clears the spans with the counters
before the window, so every root span read here is one solve of the window.
Readers of span times take the window's solves after the traced ones
(:func:`untraced`), which the profiler does not stretch; readers that join
spans with the device trace take the traced solves (:func:`traced`).  Both
clocks are ``time.time_ns``.  A program without spans gives no reading: each
function here then returns ``None``.
"""

from __future__ import annotations

from collections import defaultdict

from bench_port import harness

#: The host's CUDA calls that launch a kernel, as the profiler names them.
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx"})


def _timer(run):
    timer = run.lt.utils.timer
    return timer if hasattr(timer, "spans") else None


def enable(run) -> None:
    """Turn the program's spans on for the rest of the run (a reader's
    ``measure``)."""
    timer = _timer(run)
    if timer is not None:
        timer.set_timing(True)


def solves(run, name: str):
    """The window's solves whose root span is ``name``, in order, each as
    ``(root, descendants)``; ``None`` without spans."""
    timer = _timer(run)
    if timer is None or not timer.time_lightkrylov():
        return None
    recs = run.state.get("_spans")
    if recs is None:
        recs = run.state["_spans"] = timer.spans()
    below = defaultdict(list)
    for s in recs:
        if s.parent is not None:
            below[s.root].append(s)
    return [(r, below[r.id]) for r in recs if r.parent is None and r.name == name] or None


def untraced(run, sv):
    """The solves after the traced ones; all of them where none follows."""
    n = run.traced.steps if run.traced is not None else 0
    return sv[n:] or sv


def traced(run, sv):
    """The solves inside the traced window."""
    t = run.traced
    if t is None:
        return []
    return [(r, d) for r, d in sv if t.t0_ns <= r.t0_ns and r.t1_ns <= t.t1_ns]


def device_ms_per_solve(run, root: str, name: str):
    """The event time of the ``name`` spans a solve, in ms, averaged over
    the untraced solves; ``None`` where the spans carry no event time (no
    card)."""
    sv = solves(run, root)
    if sv is None:
        return None
    sv = untraced(run, sv)
    times = [[s.device_ms for s in d if s.name == name] for _, d in sv]
    if not any(times) or any(t is None for ts in times for t in ts):
        return None
    return sum(map(sum, times)) / len(sv)


def _reads(desc):
    return sorted((s.t0_ns, s.t1_ns) for s in desc if s.name == "host_read")


def dispatch_ms_per_solve(run, root: str):
    """Host time in the ``root`` span outside its ``host_read`` spans, in ms,
    averaged over the untraced solves."""
    sv = solves(run, root)
    if sv is None:
        return None
    sv = untraced(run, sv)
    total = sum((r.t1_ns - r.t0_ns) - sum(e - s for s, e in _reads(d)) for r, d in sv)
    return 1e-6 * total / len(sv)


def launches_per_solve(run, root: str):
    """The host's kernel launches (:data:`LAUNCH_CALLS` in the trace) inside
    the traced ``root`` spans, per traced solve."""
    sv = solves(run, root)
    if sv is None or run.traced is None:
        return None
    inside = sorted((r.t0_ns, r.t1_ns) for r, _ in traced(run, sv))
    if not inside:
        return None
    starts = sorted(s for name, s, _ in run.traced.host if name in LAUNCH_CALLS)
    n, i = 0, 0
    for s in starts:
        while i < len(inside) and inside[i][1] < s:
            i += 1
        if i < len(inside) and inside[i][0] <= s:
            n += 1
    return n / len(inside)


def _outside(span, holes):
    """``[t0, t1]`` of ``span`` less the sorted disjoint ``holes`` in it."""
    out, cur = [], span.t0_ns
    for s, e in holes:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < span.t1_ns:
        out.append((cur, span.t1_ns))
    return out


def _overlap_ns(a, b) -> int:
    """Total length of the intersection of two sorted disjoint interval lists."""
    n, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            n += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return n


def idle_dispatch_pct(run, root: str):
    """The share of the traced window, in %, in which the device is idle and
    the host is inside a traced ``root`` span but outside its ``host_read``
    spans: idle time that host dispatch, and no wait for the device,
    explains."""
    sv = solves(run, root)
    if sv is None or run.traced is None:
        return None
    dispatch = sorted(iv for r, d in traced(run, sv) for iv in _outside(r, _reads(d)))
    if not dispatch:
        return None
    t = run.traced
    idle = harness.idle_gaps(t)
    return 100.0 * _overlap_ns(dispatch, idle) / (t.t1_ns - t.t0_ns)
