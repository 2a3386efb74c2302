"""Timers, operator call counters, the host-read and the collective counts.

Counterpart of :mod:`lightkrylov_tpu.utils.timer` (reference:
src/Utilities/Timer_Utils.f90, Timer.fypp): named timers with
elapsed/min/max/count, a registry with groups, and a global enable flag that
makes the instrumentation free when off (Timer.fypp:24,45-47).

PyTorch launches CUDA work asynchronously, so a timer must wait for the
device before it stops.  Where the JAX package called ``block_until_ready``
on the routine's outputs, :func:`timed_fn` records a CUDA event on the
current stream and synchronises on it.  ``torch.profiler`` ranges carry the
timer names into device traces.
"""

from __future__ import annotations

import functools
import time
import weakref
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import logger as _logger

__all__ = [
    "Timer",
    "Watch",
    "global_watch",
    "time_lightkrylov",
    "set_timing",
    "timed",
    "timed_fn",
    "matvec_counter",
    "operator_label",
    "count_applications",
    "host_read",
    "count_collective",
    "count_event",
    "reset_counters",
    "get_counter",
    "counters_summary",
]

_timing_enabled = False


def time_lightkrylov() -> bool:
    """Global instrumentation flag (reference: Timer.fypp:24,45-47)."""
    return _timing_enabled


def set_timing(enabled: bool) -> None:
    global _timing_enabled
    _timing_enabled = enabled


@dataclass
class Timer:
    """Atomic named timer (reference: ``lightkrylov_timer``,
    Timer_Utils.f90:12-74).  :meth:`stop` and :meth:`pause` read the host
    clock and do not wait for the device: time device work with
    :func:`timed` (``device=True``) or :func:`timed_fn`."""

    name: str
    etime: float = 0.0
    tmin: float = float("inf")
    tmax: float = 0.0
    count: int = 0
    running: bool = False
    _t0: float = 0.0
    history: list = field(default_factory=list)

    def start(self):
        if not self.running:
            self.running = True
            self._t0 = time.perf_counter()

    def stop(self):
        if self.running:
            dt = time.perf_counter() - self._t0
            self.etime += dt
            self.tmin = min(self.tmin, dt)
            self.tmax = max(self.tmax, dt)
            self.count += 1
            self.running = False

    def pause(self):
        """Add the running interval to ``etime`` without counting a call."""
        if self.running:
            self.etime += time.perf_counter() - self._t0
            self.running = False

    def reset(self, soft: bool = True):
        """A soft reset archives ``(etime, tmin, tmax, count)`` to
        ``history``; a hard reset clears ``history`` too (reference: soft
        and hard reset, Timer_Utils.f90:221-419)."""
        if soft and self.count:
            self.history.append((self.etime, self.tmin, self.tmax, self.count))
        self.etime, self.tmin, self.tmax, self.count = 0.0, float("inf"), 0.0, 0
        self.running = False
        if not soft:
            self.history.clear()

    @property
    def avg(self) -> float:
        return self.etime / self.count if self.count else 0.0


class Watch:
    """Timer registry with groups (reference: ``lightkrylov_watch``,
    Timer_Utils.f90:89-158)."""

    def __init__(self, name: str = "lightkrylov_watch"):
        self.name = name
        self._timers: dict[str, Timer] = {}
        self._groups: dict[str, list[str]] = defaultdict(list)

    def add_timer(self, name: str, group: str = "user") -> Timer:
        if name not in self._timers:
            self._timers[name] = Timer(name)
            self._groups[group].append(name)
        return self._timers[name]

    def remove_timer(self, name: str) -> None:
        self._timers.pop(name, None)
        for names in self._groups.values():
            if name in names:
                names.remove(name)

    def timer(self, name: str) -> Timer:
        return self.add_timer(name)

    def reset_all(self, soft: bool = True) -> None:
        for t in self._timers.values():
            t.reset(soft=soft)

    def summary(self) -> str:
        """Grouped min/avg/max/count report
        (reference: ``print_timer_summary``, Timer_Utils.f90:221-419)."""
        lines = [f"== {self.name} timing summary =="]
        for group, names in self._groups.items():
            active = [self._timers[n] for n in names if n in self._timers and self._timers[n].count]
            if not active:
                continue
            lines.append(f"-- {group} --")
            for t in active:
                lines.append(
                    f"  {t.name:<40s} n={t.count:<6d} total={t.etime:.4e}s "
                    f"min={t.tmin:.4e}s avg={t.avg:.4e}s max={t.tmax:.4e}s"
                )
        return "\n".join(lines)

    def print_summary(self) -> None:
        _logger.log_message(self.summary())


#: Global watch, mirroring ``global_lightkrylov_timer`` (Timer.fypp:30-41).
global_watch = Watch()


def _wait_for_device() -> None:
    """Block until the current CUDA stream has run everything enqueued so
    far; a no-op when CUDA was never used in this process."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        event = torch.cuda.Event()
        event.record()
        event.synchronize()


@contextmanager
def timed(name: str, group: str = "user", device: bool = False):
    """Bracket a stage with a named timer and a profiler range (reference:
    the ``timer%start/stop`` brackets, e.g. arnoldi.fypp:18,75).  With
    ``device``, the stage's device work is timed too: the span waits for the
    device when it opens and when it closes (two synchronizations, so only
    while timing is enabled)."""
    if not _timing_enabled:
        yield
        return
    t = global_watch.add_timer(name, group)
    with torch.profiler.record_function(name):
        if device:
            _wait_for_device()
        t.start()
        try:
            yield
            if device:
                _wait_for_device()
        finally:
            t.stop()


def timed_fn(name: str, group: str = "user"):
    """Decorator timing a library routine, device work included
    (reference: Timer.fypp:67-113).  Free when timing is disabled."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with timed(name, group, device=True):
                return fn(*args, **kwargs)
        return wrapper
    return deco


# -- call counters -----------------------------------------------------------
#
# The reference counts every matvec/rmatvec on the operator instance
# (AbstractLinops.fypp:34-37,391-424).  Solvers record their executed
# applications here, keyed per operator instance: the first instance of a
# class keeps the bare class name, later live ones get a ``#n`` suffix, and
# an ``A.label`` attribute overrides the generated name.

_counters: dict[str, int] = defaultdict(int)
_instance_names: dict[int, str] = {}
_class_counts: dict[str, int] = defaultdict(int)


def operator_label(A) -> str:
    """Stable per-instance counter key for operator ``A``."""
    lbl = getattr(A, "label", None)
    if lbl:
        return str(lbl)
    if getattr(A, "_aslinop_wrapped", False):
        # wrappers minted by aslinop() inside each solve aggregate by class
        return type(A).__name__
    key = id(A)
    name = _instance_names.get(key)
    if name is None:
        base = type(A).__name__
        seq = _class_counts[base]
        _class_counts[base] += 1
        name = base if seq == 0 else f"{base}#{seq}"
        _instance_names[key] = name

        def _drop(key=key, name=name):
            # ids are reused after collection: drop only our own slot
            if _instance_names.get(key) == name:
                _instance_names.pop(key, None)

        weakref.finalize(A, _drop)
    return name


def matvec_counter(A, name: str):
    """Wrap operator ``A`` so that each application bumps the host counters
    ``name.matvec`` and ``name.rmatvec`` (reference: the ``apply_matvec``
    counting wrapper, AbstractLinops.fypp:391-424).  The port is eager, so
    every application is counted where it happens.  The block forms stay
    batched: ``matvec_basis`` of ``p`` columns calls ``A.matvec_basis`` once
    and counts ``p``."""
    from ..linops import MatvecOperator

    def bump(kind, n=1):
        _counters[f"{name}.{kind}"] += n

    def mv(x):
        bump("matvec")
        return A.matvec(x)

    def rmv(y):
        bump("rmatvec")
        return A.rmatvec(y)

    def mv_basis(X):
        bump("matvec", pytree.tree_leaves(X)[0].shape[0])
        return A.matvec_basis(X)

    def rmv_basis(Y):
        bump("rmatvec", pytree.tree_leaves(Y)[0].shape[0])
        return A.rmatvec_basis(Y)

    op = MatvecOperator(mv, rmv, is_hermitian=A.is_hermitian)
    op.matvec_basis, op.rmatvec_basis = mv_basis, rmv_basis
    return op


def count_applications(A, n: int, kind: str = "matvec") -> None:
    """Record that operator ``A`` was applied ``n`` times
    (reference: ``apply_matvec`` counting, AbstractLinops.fypp:390-424)."""
    if n:
        _counters[f"{operator_label(A)}.{kind}"] += int(n)


def host_read(t: torch.Tensor) -> np.ndarray:
    """Copy ``t`` to the host as a numpy array.  This waits until the
    device has computed it; every such wait in the solvers goes through here
    and is counted under ``"host_reads"``."""
    _counters["host_reads"] += 1
    return t.detach().cpu().numpy()


def count_collective(kind: str) -> None:
    """Record one collective over the process group: ``"all_reduces"`` for
    the vector layer's reductions (:mod:`..vectors`), ``"operator_collectives"``
    for the sharded operators' halo exchanges, gathers and adjoint sums
    (:mod:`..parallel`)."""
    _counters[kind] += 1


def count_event(name: str, n: int = 1) -> None:
    """Record ``n`` events under the counter ``name``.  The device projected
    path counts with it: ``"qr_host_redos"`` (a check whose device QR ran
    out of its sweep budget and was redone on the host), ``"library_syncs"``
    (a ``torch.linalg.eigh``/``svd`` on a CUDA tensor, which waits for the
    device to check its result), ``"ritz_checks"`` (the device checks),
    ``"ordschur_reads"`` (the host reads of the device Schur reordering,
    one a block swap and one to finish) and the restarts by kind,
    ``"restarts.<solver>.<kind>"``."""
    _counters[name] += int(n)


def reset_counters() -> None:
    """Clear all counters and the per-instance naming epoch."""
    _counters.clear()
    _instance_names.clear()
    _class_counts.clear()


def get_counter(name: str) -> int:
    return _counters[name]


def counters_summary() -> str:
    """Formatted table of all nonzero call counters (reference: the
    matvec/rmatvec counts printed by the operator finalizers)."""
    lines = ["== call counters =="]
    for name in sorted(_counters):
        lines.append(f"  {name:<40s} {_counters[name]}")
    return "\n".join(lines)

