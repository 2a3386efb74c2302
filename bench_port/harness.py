"""The benchmark's shared machinery: finding a cell's files by name, the
whole-window statistics, the reduction of a profiler trace to busy time,
idle gaps and device operations, the result line, and the guard against
JAX in the process.

Nothing here imports the program under test or JAX: the loops in
``loops/`` drive the program, the readers in ``metrics/`` turn a finished
run into per-layer numbers, and ``reference/`` checks the answers.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: The H100 SXM datasheet rate of device memory, the denominator of every
#: byte roofline here (NVIDIA H100 data sheet, 3.35 TB/s).
HBM_BYTES_PER_S = 3.35e12
#: Top-level module names that may not be loaded in a benchmark process:
#: JAX itself and the JAX package the program was ported from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "lightkrylov_tpu")
#: Where the program's and the libraries' kernel caches live: fixed
#: directories inside the checkout, so that only a cell's first run builds.
CACHE_DIR = HERE / ".cache"


class BenchError(RuntimeError):
    """A run that cannot produce a result (no card, a missing file, a
    forbidden module): the command exits non-zero and prints no result."""


def set_cache_dirs(environ=os.environ) -> None:
    """Point the kernel caches that PyTorch's libraries honour at fixed
    directories inside the checkout.  The program builds its own CUDA
    library into ``lightkrylov_tpu_torch/_build/``, also inside it."""
    environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")


# -- a cell's files ------------------------------------------------------------

def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with everything found by its names: the
    configuration file, the traffic mix, the limits of its comparisons and
    the metrics it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def loop(self) -> str:
        return self.traffic["loop"]


def find_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``), its
    configuration from the entry's ``file``, its traffic mix from
    ``bench_port/traffic/<traffic>.json`` and its limits from
    ``bench_port/limits/<cell>.json``."""
    if bench is None:
        bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "bench_port" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "bench_port" / "limits" / f"{name}.json")

    def reports(metric):
        return name in metric.get("workloads", [name])

    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if reports(m)],
                per_layer=[m for m in bench["per_layer"] if reports(m)])


def load_module(kind: str, name: str, root: Path = ROOT):
    """The module ``bench_port/<kind>/<name>.py``, loaded from its file
    (a metric's name may hold dots)."""
    path = root / "bench_port" / kind / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no {kind} module {path.relative_to(root)}")
    spec = importlib.util.spec_from_file_location(f"bench_port_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- whole-window statistics -----------------------------------------------------

def per_step(window_s: float, steps: int) -> float:
    """The window's whole elapsed time over the steps it completed."""
    if steps <= 0:
        raise BenchError("the window completed no step")
    return window_s / steps


def p95(times) -> float:
    """The 95th percentile of ``times`` by nearest rank: the smallest value
    that at least 95% of the samples do not exceed."""
    xs = sorted(times)
    if not xs:
        raise BenchError("no samples for a percentile")
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def statistic(kind: str, step_times, window_s: float) -> float:
    """An end-to-end metric by the statistic a traffic mix names for it:
    ``per_step`` (the whole window over its steps) or ``p95`` (of every
    step's own time)."""
    if kind == "per_step":
        return per_step(window_s, len(step_times))
    if kind == "p95":
        return p95(step_times)
    raise BenchError(f"unknown statistic {kind!r}")


# -- the profiler trace ------------------------------------------------------------

@dataclass
class Trace:
    """A traced window reduced to plain tuples: device activities
    ``(name, start_ns, end_ns)`` and the main host thread's operations
    ``(name, start_ns, end_ns)``, clipped to ``[t0_ns, t1_ns]``."""

    device: list
    host: list
    t0_ns: int
    t1_ns: int
    steps: int = 0

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9


def merge(intervals, t0: int, t1: int):
    """The union of ``(start, end)`` intervals clipped to ``[t0, t1]``, as
    sorted disjoint intervals."""
    out = []
    for s, e in sorted((max(s, t0), min(e, t1)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_ns(trace: Trace) -> int:
    """Nanoseconds in which some operation ran on the device."""
    return sum(e - s for s, e in merge(((s, e) for _, s, e in trace.device),
                                       trace.t0_ns, trace.t1_ns))


def idle_gaps(trace: Trace):
    """The stretches of the window in which no operation ran on the
    device, as ``(start, end)``."""
    busy = merge(((s, e) for _, s, e in trace.device), trace.t0_ns, trace.t1_ns)
    gaps, cur = [], trace.t0_ns
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < trace.t1_ns:
        gaps.append((cur, trace.t1_ns))
    return gaps


def gaps_by_host(trace: Trace, top: int = 10):
    """Idle device time summed by what the host was doing at each gap's
    midpoint: the innermost host operation that covers it, or ``python``
    where none does.  The ``top`` largest, as ``[name, seconds]``."""
    gaps = sorted(idle_gaps(trace), key=lambda g: (g[0] + g[1]) / 2)
    host = sorted(trace.host, key=lambda h: (h[1], -h[2]))
    totals: dict[str, int] = {}
    stack, i = [], 0
    for s, e in gaps:
        mid = (s + e) / 2
        while i < len(host) and host[i][1] <= mid:
            while stack and stack[-1][2] <= host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = stack[-1][0] if stack else "python"
        totals[name] = totals.get(name, 0) + (e - s)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns * 1e-9] for name, ns in ranked]


def device_ops(trace: Trace, top: int = 10):
    """Device time summed by operation name, the ``top`` largest, as
    ``[name, seconds]``."""
    totals: dict[str, int] = {}
    for name, s, e in trace.device:
        s, e = max(s, trace.t0_ns), min(e, trace.t1_ns)
        if e > s:
            totals[name] = totals.get(name, 0) + (e - s)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns * 1e-9] for name, ns in ranked]


def from_kineto(prof, t0_ns: int, t1_ns: int) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` to a :class:`Trace`:
    kernels, copies and fills on the card, and the operations of the host
    thread that recorded the most of them."""
    from torch.autograd import DeviceType

    device, host_by_thread = [], {}
    for ev in prof.profiler.kineto_results.events():
        s, e = ev.start_ns(), ev.end_ns()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((ev.name(), s, e))
        elif not ev.is_async():
            host_by_thread.setdefault(ev.start_thread_id(), []).append((ev.name(), s, e))
    host = max(host_by_thread.values(), key=len) if host_by_thread else []
    return Trace(device=device, host=host, t0_ns=t0_ns, t1_ns=t1_ns)


# -- the result -------------------------------------------------------------------

def forbidden_loaded(modules=None):
    """Forbidden top-level module names present in ``sys.modules``, each
    compared whole (``lightkrylov_tpu_torch`` is not ``lightkrylov_tpu``)."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in modules}
    return sorted(tops & set(FORBIDDEN_MODULES))


def check_entry(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}


def checks_ok(checks: dict) -> bool:
    """Every compared number within its limit, and finite."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def result_line(*, correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> str:
    """The contract's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, ``breakdown`` when traced, and the compared
    numbers with their limits last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def checks_text(checks: dict) -> str:
    return "\n".join(f"check {name}: {c['value']!r} (limit {c['limit']!r})"
                     for name, c in checks.items())
