"""One run of one cell: set-up, the measured window, the traced window, the
per-layer readers, the comparison with the reference, and the result.

``run_cell`` runs in the process that prints the result (rank 0).  A cell
on several chips spawns one process a further rank; every rank runs
:func:`run_rank` and reaches the others through ``torch.distributed``
(NCCL on the card, gloo on the CPU where the tests drive it).
"""

from __future__ import annotations

import importlib
import os
import socket
import sys
import time
from dataclasses import dataclass, field

from . import harness
from .harness import BenchError

RANK_JOIN_S = 120  # how long a finished run waits for its other rank processes
COLLECTIVE_TIMEOUT_S = 120  # the process group's rendezvous and collectives


@dataclass
class Run:
    """What a loop, a reader and the check see of a run."""

    cell: harness.Cell
    seed: int
    seconds: float
    trace: bool
    device: object          # torch.device
    rank: int
    world: int
    t_start: float          # the process's start, on time.monotonic()
    lt: object = None       # the program under test
    state: dict = field(default_factory=dict)
    step_times: list = field(default_factory=list)
    failed: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    counters: dict = field(default_factory=dict)
    loop: object = None     # the traffic mix's loop module
    traced: harness.Trace | None = None
    memory_peak_bytes: int = 0

    @property
    def steps(self) -> int:
        return len(self.step_times)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    def generator(self, *key) -> object:
        """A ``torch.Generator`` on this run's device, seeded from the run's
        seed and ``key`` (whole numbers), the same on every rank."""
        import torch
        s = self.seed
        for k in key:
            s = (s * 1_000_003 + int(k) + 1) % (2**63)
        return torch.Generator(device=self.device).manual_seed(s)


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc``; 0 where that is
    not readable."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _loop(cell):
    return harness.load_module("loops", cell.loop)


def _readers(cell):
    return {m["name"]: harness.load_module("metrics", m["name"]) for m in cell.per_layer}


def _apply_patch(patch):
    """Run ``module:function`` before the run: the tests break the timed
    path underneath with it."""
    if patch:
        mod, fn = patch.split(":")
        getattr(importlib.import_module(mod), fn)()


def _window(run: Run, loop, dist, profile: bool) -> None:
    """Steps back to back until ``seconds`` have passed and the last step
    has ended; with ``profile``, under ``torch.profiler`` for the traffic
    mix's ``trace_steps`` first steps (all of them where it gives none)."""
    import torch

    trace_steps = run.cell.traffic.get("trace_steps") if profile else None
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile
        # on the card the device's activity and the host's CUDA calls alone:
        # recording every host operation besides stretched a cycle 1.6x, these 1.2x
        acts = [ProfilerActivity.CUDA] if run.cuda else [ProfilerActivity.CPU]
        prof = torch_profile(activities=acts)
    flag = torch.zeros(1, dtype=torch.int32, device=run.device)
    if prof is not None:  # started outside the window: its own start-up is slow
        prof.__enter__()
        t_prof0 = time.time_ns()  # the profiler stamps events on this clock
    t0 = time.perf_counter()
    i = 0
    while True:
        if dist is not None:  # rank 0 decides for all ranks
            flag.fill_(int(time.perf_counter() - t0 < run.seconds or i == 0))
            dist.broadcast(flag, 0)
            go = bool(flag.item())
        else:
            go = time.perf_counter() - t0 < run.seconds or i == 0
        if not go:
            break
        s = time.perf_counter()
        run.failed += int(bool(loop.step(run, i)))
        run.sync()
        run.step_times.append(time.perf_counter() - s)
        i += 1
        if prof is not None and (trace_steps is not None and i == trace_steps):
            t_prof1 = time.time_ns()
            prof.__exit__(None, None, None)
            run.traced = harness.from_kineto(prof, t_prof0, t_prof1)
            run.traced.steps = i
            prof = None
    run.window_s = time.perf_counter() - t0
    if prof is not None:
        t_prof1 = time.time_ns()
        prof.__exit__(None, None, None)
        run.traced = harness.from_kineto(prof, t_prof0, t_prof1)
        run.traced.steps = i


def run_rank(cell_name: str, seed: int, seconds: float, trace: bool, device: str,
             rank: int = 0, world: int = 1, init_method: str | None = None,
             t_start: float | None = None, patch: str | None = None,
             bench: dict | None = None):
    """Run one rank of a cell; rank 0 returns ``(result_line, checks_text)``,
    the others ``None``."""
    t_start = time.monotonic() - process_age_s() if t_start is None else t_start
    cell = harness.find_cell(cell_name, bench)
    harness.set_cache_dirs()
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    _apply_patch(patch)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise BenchError(f"the cell needs {cell.chips} CUDA device(s); "
                             f"{torch.cuda.device_count()} visible")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    run = Run(cell=cell, seed=int(seed), seconds=float(seconds), trace=bool(trace), device=dev,
              rank=rank, world=world, t_start=t_start)

    import logging
    import lightkrylov_tpu_torch as lt
    logging.getLogger("lightkrylov_tpu_torch").setLevel(logging.ERROR)
    run.lt = lt
    lt.set_default_device(dev.type)
    dist = None
    if world > 1:
        import torch.distributed as dist
        os.environ["LOCAL_RANK"] = str(rank)
        lt.comm_setup("nccl" if run.cuda else "gloo", init_method=init_method,
                      world_size=world, rank=rank, timeout=COLLECTIVE_TIMEOUT_S, device=dev.type)
    try:
        return _run(run, dist, cell)
    finally:
        if world > 1:
            lt.comm_close()


def _run(run: Run, dist, cell):
    import torch
    lt = run.lt
    loop = _loop(cell)
    readers = _readers(cell) if run.trace else {}
    if run.cuda:
        lt.ops._build.load()
    run.loop = loop
    loop.setup(run)
    run.sync()
    run.setup_s = time.monotonic() - run.t_start
    # readers that take a measurement of their own (a timed run of an
    # operator, a solve with the program's timing on) take it now, before
    # any profiler has run in the process and outside the counted window
    for r in readers.values():
        if hasattr(r, "measure"):
            r.measure(run)
    run.sync()
    if dist is not None:
        dist.barrier()
    lt.utils.timer.reset_counters()
    if run.cuda:
        torch.cuda.reset_peak_memory_stats(run.device)

    _window(run, loop, dist, profile=run.trace)

    for r in readers.values():
        for name in getattr(r, "COUNTERS", ()):
            run.counters[name] = lt.utils.timer.get_counter(name)
    if run.cuda:
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(run.device))
    found = harness.forbidden_loaded()

    metrics = {}
    if run.trace:
        for name, reader in readers.items():
            value = reader.read(run)
            if value is not None:
                unit = next(m["unit"] for m in cell.per_layer if m["name"] == name)
                metrics[name] = {"value": float(value), "unit": unit}
    else:
        stats = cell.traffic["end_to_end"]
        for m in cell.end_to_end:
            value = run.setup_s if m["name"] == "setup_s" else harness.statistic(
                stats[m["name"]], run.step_times, run.window_s)
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    busy = harness.busy_ns(run.traced) * 1e-9 if run.traced is not None else None
    gathered = {"memory": run.memory_peak_bytes, "busy": busy, "found": found}
    if dist is not None:
        parts = [None] * run.world
        dist.all_gather_object(parts, gathered)
    else:
        parts = [gathered]

    checks = loop.check(run)  # every rank takes part; rank 0 judges
    if run.rank != 0:
        return None
    found = sorted({m for p in parts for m in p["found"]} | set(harness.forbidden_loaded()))
    if found:
        raise BenchError(f"forbidden modules loaded in the benchmark: {found}")
    device = {"platform": "gpu" if run.cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if run.cuda else "cpu",
              "count": run.world,
              "memory_peak_bytes": max(p["memory"] for p in parts)}
    breakdown = None
    if run.traced is not None:
        device["busy_s"] = sum(p["busy"] for p in parts) / len(parts)
        device["window_s"] = run.traced.window_s
        breakdown = {"device_ops": harness.device_ops(run.traced),
                     "idle_gaps": harness.gaps_by_host(run.traced)}
    line = harness.result_line(correct=harness.checks_ok(checks), attempted=run.steps,
                               failed=run.failed, metrics=metrics, device=device,
                               checks=checks, breakdown=breakdown)
    return line, harness.checks_text(checks)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             patch: str | None = None, bench: dict | None = None, world: int | None = None):
    """Run the cell, spawning its further ranks; returns what rank 0
    returns.  ``world`` defaults to the configuration's ``ranks``."""
    t_start = time.monotonic() - process_age_s()
    cell = harness.find_cell(cell_name, bench)
    world = int(cell.config.get("ranks", 1)) if world is None else world
    if world == 1:
        return run_rank(cell_name, seed, seconds, trace, device, t_start=t_start, patch=patch,
                        bench=bench)
    import multiprocessing as mp
    if device == "cuda":
        _build_kernels()
    ctx = mp.get_context("spawn")
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=run_rank,
                         args=(cell_name, seed, seconds, trace, device, r, world, init_method,
                               None, patch, bench))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        out = run_rank(cell_name, seed, seconds, trace, device, 0, world, init_method,
                       t_start=t_start, patch=patch, bench=bench)
    finally:
        for p in procs:
            p.join(timeout=RANK_JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise BenchError(f"rank processes exited with {codes}")
    return out


def _build_kernels() -> None:
    """Build the program's CUDA library once, before the rank processes
    start, so that they do not all compile it."""
    from lightkrylov_tpu_torch.ops import _build
    _build.build()


def main_exit(fn) -> int:
    """Call ``fn`` and turn a :class:`BenchError` into exit code 2 with the
    reason on standard error."""
    try:
        return fn()
    except BenchError as e:
        print(f"bench_port: {e}", file=sys.stderr)
        return 2
