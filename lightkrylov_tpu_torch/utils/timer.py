"""Timers, spans, operator call counters, the host-read and the collective counts.

Counterpart of :mod:`lightkrylov_tpu.utils.timer` (reference:
src/Utilities/Timer_Utils.f90, Timer.fypp): named timers with
elapsed/min/max/count, a registry with groups, and a global enable flag that
makes the instrumentation free when off (Timer.fypp:24,45-47).

**Spans.**  While timing is on (:func:`set_timing`, the reference's
``time_lightkrylov`` flag), every :func:`timed` bracket and every
:func:`timed_fn` routine records a :class:`Span`: its name, an ``id``, the
``parent`` (innermost open span) and ``root`` (outermost open span: the
solve) ids, and host stamps ``t0_ns``/``t1_ns`` from :func:`time.time_ns`,
the clock ``torch.profiler`` stamps its events on, so spans line up with a
device trace.  A ``device`` span in a process that uses CUDA records a CUDA
event on the current stream when it opens and when it closes and never
waits for the device: the events are read when the spans are read, and the
span's timer takes the device time between them.  PyTorch launches CUDA
work asynchronously, so the host stamps of a device span measure the
dispatch and its events the device's work.  :func:`host_read` records a
host-only span ``host_read``.  With timing off a bracket costs one flag
test.  Read them with :func:`spans` (the closed spans, device times read)
and :func:`span_summary` (per name: count, host time, self host time,
device time); :func:`reset_counters` clears them with the counters::

    lt.set_timing(True)
    lt.gmres(A, b)
    lt.timer.span_summary()["gmres.orth"]["device_ms"]

The solvers' spans: ``gmres``, ``fgmres``, ``cg`` (one a solve, the root);
``gmres.cycle`` (a restart cycle) with ``gmres.matvec`` (preconditioner and
operator), ``gmres.orth`` (the basis work of a step), ``gmres.lsq`` (the
Givens update) and ``gmres.update`` (the cycle's correction); ``cg.matvec``
and ``cg.update`` (the rest of an iteration); ``eigs`` (the root) with
``eigs.cycle`` (a restart cycle of the device projected path) holding
``eigs.check`` (a device Ritz check) and ``eigs.restart`` (a restart, also
on the host path, whose checks are ``eigs.projected_eig``); ``arnoldi.step``
with ``arnoldi.matvec`` and ``arnoldi.orth``; ``allreduce`` (a vector reduction
over the process group) and ``halo`` (an operator's collective);
``bell.spmv`` (a Block-ELL kernel launch of ``BellOperator``, inside the
solver's matvec span) and ``bell.assemble`` (``bell_from_scipy``'s layout,
host only); and ``host_read``.  The benchmark reads them in its traced runs,
``python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace 1`` (``bench_port/metrics/``).

While a ``torch.profiler`` run is active, each span also opens a
``record_function`` range of its name, so an operator's own profile shows
the solver's layers around the kernels.
"""

from __future__ import annotations

import functools
import itertools
import time
import weakref
from collections import defaultdict, deque
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
    "Span",
    "spans",
    "span_summary",
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
    :func:`timed` (``device=True``) or :func:`timed_fn`, whose timers take
    the device time between two CUDA events."""

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
            _tally(self, time.perf_counter() - self._t0)
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
        _read_events(wait=True)
        return self.add_timer(name)

    def reset_all(self, soft: bool = True) -> None:
        _read_events(wait=True)
        for t in self._timers.values():
            t.reset(soft=soft)

    def summary(self) -> str:
        """Grouped min/avg/max/count report
        (reference: ``print_timer_summary``, Timer_Utils.f90:221-419)."""
        _read_events(wait=True)
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


# -- spans -------------------------------------------------------------------


class Span:
    """One recorded :func:`timed` bracket.  ``id`` is unique in the process;
    ``parent`` is the id of the innermost span open when it opened (``None``
    for a root) and ``root`` that of the outermost (its own id for a root):
    the solve.  ``t0_ns``/``t1_ns`` are host stamps from
    :func:`time.time_ns`.  ``device_ms`` is the device time between the
    span's two CUDA events, ``None`` for a host-only span and until the
    events are read (:func:`spans` reads them)."""

    __slots__ = ("name", "id", "parent", "root", "t0_ns", "t1_ns", "device_ms",
                 "_timer", "_device", "_events", "_range")

    def __init__(self, name: str, group: str, device: bool):
        self.name = name
        self._timer = global_watch._timers.get(name) or global_watch.add_timer(name, group)
        self._device = device
        self.device_ms = self._events = self._range = None

    def __enter__(self):
        self.id = next(_span_ids)
        if _open:
            self.parent, self.root = _open[-1].id, _open[0].id
        else:
            self.parent = None
            self.root = self.id
        _open.append(self)
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.t0_ns = time.time_ns()
        if self._device and torch.cuda.is_initialized():
            self._events = _event_pair()
            self._events[0].record()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        self.t1_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if _open[-1] is self:
            _open.pop()
        else:  # a bracket inside was left open
            _open.remove(self)
        _finished.append(self)
        if self._events is None:
            _tally(self._timer, (self.t1_ns - self.t0_ns) * 1e-9)
        else:
            _pending.append(self)
        return False


class _Off:
    """What :func:`timed` returns while timing is off: a bracket that does
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_span_ids = itertools.count(1)
_open: list[Span] = []          # the open spans, outermost first
_finished: list[Span] = []      # closed spans, in closing order
_pending: deque[Span] = deque()  # closed device spans whose events are unread
_event_pool: list = []          # recorded-and-read CUDA events, for reuse


def _tally(t: Timer, dt: float) -> None:
    """Count one call of ``dt`` seconds on ``t``, as :meth:`Timer.stop` does."""
    t.etime += dt
    if dt < t.tmin:
        t.tmin = dt
    if dt > t.tmax:
        t.tmax = dt
    t.count += 1


def _event_pair():
    """Two timing CUDA events: read ones from the pool where the device has
    passed them, new ones otherwise.  ``torch.Event`` records on the current
    stream without the Python stream object that ``torch.cuda.Event.record``
    builds on every call."""
    if len(_event_pool) < 2:
        _read_events(wait=False)
    if len(_event_pool) >= 2:
        return _event_pool.pop(), _event_pool.pop()
    return (torch.Event(device="cuda", enable_timing=True),
            torch.Event(device="cuda", enable_timing=True))


def _read_events(wait: bool) -> None:
    """Read the device time of the closed device spans, oldest first, into
    the spans and their timers, and return their events to the pool.
    Without ``wait`` it stops at the first span the device has not passed
    yet (``Event.query`` of its closing event: both are on one stream); with
    ``wait`` it waits for each."""
    while _pending:
        span = _pending[0]
        start, end = span._events
        if wait:
            end.synchronize()
            start.synchronize()
        elif not end.query():
            return
        _pending.popleft()
        span.device_ms = start.elapsed_time(end)
        span._events = None
        _event_pool.extend((start, end))
        _tally(span._timer, span.device_ms * 1e-3)


def timed(name: str, group: str = "user", device: bool = False):
    """Bracket a stage with a named timer and a span, for ``with`` (reference:
    the ``timer%start/stop`` brackets, e.g. arnoldi.fypp:18,75).  While
    timing is off it returns a bracket that does nothing.  With ``device``,
    on a process that uses CUDA, the span records a CUDA event on the
    current stream when it opens and when it closes, and its timer takes the
    device time between them once they are read; nothing waits for the
    device."""
    if not _timing_enabled:
        return _OFF
    return Span(name, group, device)


def timed_fn(name: str, group: str = "user"):
    """Decorator timing a library routine, device work included
    (reference: Timer.fypp:67-113).  Free when timing is disabled."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _timing_enabled:
                return fn(*args, **kwargs)
            with Span(name, group, True):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def spans() -> list[Span]:
    """The closed spans since the last :func:`reset_counters`, in closing
    order, their device times read (this waits for the device to pass the
    last span's events)."""
    _read_events(wait=True)
    return list(_finished)


def span_summary() -> dict[str, dict]:
    """Per span name: ``count``, ``host_s`` (host time inside), ``self_host_s``
    (host time inside minus the part its child spans cover) and
    ``device_ms`` (the sum of its event times; ``None`` for host-only
    spans)."""
    recs = spans()
    covered: dict[int, int] = defaultdict(int)
    for s in recs:
        if s.parent is not None:
            covered[s.parent] += s.t1_ns - s.t0_ns
    out: dict[str, dict] = {}
    for s in recs:
        row = out.setdefault(s.name, {"count": 0, "host_s": 0.0, "self_host_s": 0.0,
                                      "device_ms": None})
        dur = s.t1_ns - s.t0_ns
        row["count"] += 1
        row["host_s"] += dur * 1e-9
        row["self_host_s"] += (dur - covered.get(s.id, 0)) * 1e-9
        if s.device_ms is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + s.device_ms
    return out


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
    and is counted under ``"host_reads"``, and is a host-only span
    ``host_read`` while timing is on, in which the events of the device spans
    the device has passed are read."""
    _counters["host_reads"] += 1
    if not _timing_enabled:
        return t.detach().cpu().numpy()
    with Span("host_read", "host", False):
        _read_events(wait=False)  # while the device runs what the copy waits for
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
    ``"restarts.<solver>.<kind>"``; the fused routes count their steps,
    ``"cg.fused_iterations"`` and ``"gmres.fused_steps"``, once a solve;
    ``BellOperator`` counts ``"bell.nnz_applied"``, its matrix's ``nnz`` for
    every vector it multiplies."""
    _counters[name] += int(n)


def reset_counters() -> None:
    """Clear all counters, the per-instance naming epoch and the closed
    spans (their device times are read into their timers first)."""
    _read_events(wait=True)
    _finished.clear()
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

