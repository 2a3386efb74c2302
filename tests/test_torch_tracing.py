"""The timing layer's spans (``lightkrylov_tpu_torch.utils.timer``) and the
counters that timing must not change.

On the CPU: every solver emits its named spans with consistent ``id``,
``parent`` and ``root``; timing off records nothing; ``reset_counters``
clears the spans; the stamps are on ``time.time_ns``; a span's self time is
its duration less its children's; a device span reads its CUDA events
without a synchronisation (fake events stand in for the card); and each
solver and factorisation counts the same operator applications, host reads
and restarts with timing off and on.

The tests marked ``cuda`` hold a span's event time to CUDA events taken
around it, and its host stamps to a ``torch.profiler`` trace; this file
imports no JAX, so on the card they run with
``python -m pytest --noconftest -m cuda tests/test_torch_tracing.py``.
"""

import time
from collections import Counter

import numpy as np
import pytest
import torch

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch.krylov.arnoldi import initialize_arnoldi_block
from lightkrylov_tpu_torch.utils import timer

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    timer.reset_counters()
    yield
    lt.set_timing(False)
    timer.reset_counters()
    # the solves' timers too, so that no later test in this process sees them
    lt.global_watch.reset_all(soft=False)
    lt.constants.set_default_device(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rng(seed):
    return np.random.default_rng(seed)


def _poisson(n=10):
    return lt.Poisson2D(n, dtype=torch.float64)


def _rhs(n=10, seed=1):
    return torch.from_numpy(_rng(seed).standard_normal((n, n)))


def _dense(n=40, seed=2, symmetric=False):
    a = _rng(seed).standard_normal((n, n)) / np.sqrt(n)
    if symmetric:
        a = (a + a.T) / 2
    return lt.DenseOperator(torch.from_numpy(a))


def _vec(n=40, seed=3):
    return torch.from_numpy(_rng(seed).standard_normal(n))


def _diagonal_breakdown():
    """``diag(1..8)`` from a start in the span of two eigenvectors: Arnoldi
    breaks down at step 2 of 5."""
    op = lt.DenseOperator(torch.diag(torch.arange(1.0, 9.0, dtype=torch.float64)))
    x0 = torch.zeros(8, dtype=torch.float64)
    x0[2], x0[5] = 1.0, 2.0
    X, H = lt.initialize_arnoldi(x0, 5)
    _, _, info = lt.arnoldi(op, X, H, kstart=1, kend=5)
    assert int(info) == 2
    return info


def _gmres(orth):
    def run():
        opts = lt.GMRESOptions(kdim=8, maxiter=3, orthogonalization=orth)
        return lt.gmres(_poisson(), _rhs(), rtol=1e-12, atol=0.0, options=opts)
    return run


def _arnoldi():
    X, H = lt.initialize_arnoldi(_vec(), 12)
    return lt.arnoldi(_dense(), X, H, kstart=1, kend=12)


def _arnoldi_block():
    X, H = initialize_arnoldi_block(_vec(), 12, 3, generator=torch.Generator().manual_seed(4))
    return lt.arnoldi_block(_dense(), X, H, 3, kstart=1, kend=12)


def _lanczos():
    X, T = lt.initialize_lanczos(_vec(), 12)
    return lt.lanczos(_dense(symmetric=True), X, T, kstart=1, kend=12)


def _bidiag():
    U, V, B = lt.initialize_bidiag(_vec(), torch.zeros(40, dtype=torch.float64), 10)
    return lt.bidiagonalization(_dense(), U, V, B, kstart=1, kend=10)


#: Each solver and factorisation, run as a user runs it.
RUNS = {
    "gmres-dcgs2": _gmres("dcgs2"),
    "gmres-cgs2": _gmres("cgs2"),
    "fgmres": lambda: lt.fgmres(_poisson(), _rhs(), rtol=1e-10, atol=0.0,
                                preconditioner=lt.BlockJacobiPoisson(_poisson()),
                                options=lt.GMRESOptions(kdim=6, maxiter=4)),
    "cg": lambda: lt.cg(_poisson(), _rhs(), rtol=1e-10, atol=0.0),
    "eigs": lambda: lt.eigs(_dense(), 3, x0=_vec(), kdim=10, tolerance=1e-10,
                            options=lt.EigsOptions(maxiter=30)),
    "eigs-device": lambda: lt.eigs(_dense(), 3, x0=_vec(), kdim=10, tolerance=1e-10,
                                   check_every=5,
                                   options=lt.EigsOptions(maxiter=30, projected="device")),
    "eighs": lambda: lt.eighs(_dense(symmetric=True), 3, x0=_vec(), kdim=10,
                              tolerance=1e-10, options=lt.EigsOptions(maxiter=30)),
    "svds": lambda: lt.svds(_dense(), 3, u0=_vec(), kdim=10, tolerance=1e-10,
                            options=lt.SVDSOptions(maxiter=30)),
    "arnoldi": _arnoldi,
    "arnoldi-breakdown": _diagonal_breakdown,
    "arnoldi_block": _arnoldi_block,
    "lanczos": _lanczos,
    "bidiagonalization": _bidiag,
}


def _counted():
    """The counters that timing must leave alone: host reads, operator
    applications and restarts."""
    return {k: v for k, v in timer._counters.items()
            if k == "host_reads" or k.endswith((".matvec", ".rmatvec"))
            or k.startswith("restarts.")}


@pytest.mark.parametrize("case", list(RUNS))
def test_timing_changes_no_counter(case):
    counts = []
    for on in (False, True):
        timer.reset_counters()
        lt.set_timing(on)
        try:
            RUNS[case]()
        finally:
            lt.set_timing(False)
        counts.append(_counted())
    off, on = counts
    assert any(k.endswith(".matvec") and v > 0 for k, v in off.items()), off
    assert on == off


def test_a_breakdown_step_counts_its_application():
    """The step that breaks down applied its operator: two of five."""
    _diagonal_breakdown()
    assert timer.get_counter("DenseOperator.matvec") == 2


def test_eigs_counts_each_application_once():
    """``eigs`` leaves the count to ``arnoldi``, which applied the operator:
    the counter equals the matvecs of the metadata, timing on or off."""
    for on in (False, True):
        timer.reset_counters()
        lt.set_timing(on)
        try:
            *_, meta = RUNS["eigs"]()
        finally:
            lt.set_timing(False)
        assert timer.get_counter("DenseOperator.matvec") == meta.n_iter


# -- the spans -----------------------------------------------------------------


def _traced(run):
    timer.reset_counters()
    lt.set_timing(True)
    try:
        out = run()
    finally:
        lt.set_timing(False)
    return out, timer.spans()


def _check_tree(recs):
    """Ids unique; a root is its own root with no parent; every other span's
    parent was open around it and shares its root."""
    by_id = {s.id: s for s in recs}
    assert len(by_id) == len(recs)
    for s in recs:
        assert s.t0_ns <= s.t1_ns
        if s.parent is None:
            assert s.root == s.id
            continue
        p = by_id[s.parent]
        assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
        assert s.root == p.root
    return [s for s in recs if s.parent is None]


@pytest.mark.parametrize("case,names", [
    ("gmres-dcgs2", {"gmres", "gmres.cycle", "gmres.matvec", "gmres.orth", "gmres.lsq",
                     "gmres.update", "host_read"}),
    ("gmres-cgs2", {"gmres", "gmres.cycle", "gmres.matvec", "gmres.orth", "gmres.lsq",
                    "gmres.update", "host_read"}),
    ("fgmres", {"fgmres", "gmres.cycle", "gmres.matvec", "gmres.orth", "gmres.lsq",
                "gmres.update", "host_read"}),
    ("cg", {"cg", "cg.matvec", "cg.update", "host_read"}),
    ("eigs", {"eigs", "krylov.arnoldi", "arnoldi.step", "arnoldi.matvec", "arnoldi.orth",
              "eigs.projected_eig", "host_read"}),
])
def test_each_solver_emits_its_spans(case, names):
    out, recs = _traced(RUNS[case])
    meta = out[-1]
    roots = _check_tree(recs)
    root_name = case.split("-")[0]
    assert [r.name for r in roots] == [root_name]  # one root a solve
    assert names <= {s.name for s in recs}
    counts = Counter(s.name for s in recs)
    assert counts["host_read"] == timer.get_counter("host_reads")
    if root_name in ("gmres", "fgmres"):
        assert counts["gmres.cycle"] == meta.n_iter  # one a restart
        assert counts["gmres.matvec"] == timer.get_counter("Poisson2D.matvec")
        cycles = {s.id for s in recs if s.name == "gmres.cycle"}
        assert all(s.parent in cycles for s in recs if s.name in ("gmres.orth", "gmres.update"))
    if root_name == "cg":
        assert counts["cg.matvec"] == timer.get_counter("Poisson2D.matvec") == meta.n_iter + 1
        # an unpreconditioned real solve takes the fused route, whose update
        # is two spans an iteration, one on each side of the flag's read
        assert timer.get_counter("cg.fused_iterations") == meta.n_iter
        assert counts["cg.update"] == 2 * meta.n_iter
    if root_name == "eigs":
        steps = {s.id for s in recs if s.name == "arnoldi.step"}
        assert counts["arnoldi.step"] == meta.n_iter
        assert all(s.parent in steps for s in recs if s.name in ("arnoldi.matvec",
                                                                   "arnoldi.orth"))


def _bell_gmres():
    """A GMRES(10) cycle on ``ConvectionDiffusion2D(12)`` as an assembled
    Block-ELL matrix (8 x 16 blocks), the operator labelled ``bell``."""
    import scipy.sparse as sp
    A = sp.csr_matrix(lt.ConvectionDiffusion2D(12).dense().numpy())
    op = lt.BellOperator(lt.bell_from_scipy(A, bm=8, bn=16, dtype=torch.float64, device="cpu"))
    op.label = "bell"
    lt.gmres(op, _vec(144, 7), rtol=0.0, atol=0.0, options=lt.GMRESOptions(kdim=10, maxiter=1))
    return op


def test_bell_spmv_spans_sit_inside_the_solver_matvec():
    """Each application of a ``BellOperator`` is one ``bell.spmv`` span
    inside a ``gmres.matvec``; with timing off there is none; the layout's
    assembly is one ``bell.assemble`` root."""
    timer.reset_counters()
    _bell_gmres()
    assert not timer.spans()
    _, recs = _traced(_bell_gmres)
    _check_tree(recs)
    by_id = {s.id: s for s in recs}
    spmv = [s for s in recs if s.name == "bell.spmv"]
    assert len(spmv) == timer.get_counter("bell.matvec") == 12  # kdim + 2
    assert all(by_id[s.parent].name == "gmres.matvec" for s in spmv)
    assert [s.parent for s in recs if s.name == "bell.assemble"] == [None]


def test_bell_counters_do_not_depend_on_timing():
    """``bell.nnz_applied`` (the matrix's nnz a vector) and the launches
    read the same with timing off and on."""
    counts = []
    for on in (False, True):
        timer.reset_counters()
        lt.set_timing(on)
        try:
            op = _bell_gmres()
        finally:
            lt.set_timing(False)
        counts.append({k: timer.get_counter(k) for k in ("bell.nnz_applied", "bell.matvec",
                                                          "launches.bell_spmv")})
    assert counts[0] == counts[1]
    assert counts[0]["bell.nnz_applied"] == op.nnz * counts[0]["bell.matvec"] > 0


def _eigs_budget(projected):
    """``eigs`` at ``tolerance = 0``: no pair converges, so it runs its 4
    cycles and restarts 3 times."""
    return lambda: lt.eigs(_dense(), 3, x0=_vec(), kdim=10, tolerance=0.0, check_every=3,
                           options=lt.EigsOptions(maxiter=4, projected=projected))


def test_eigs_device_spans_a_cycle_a_restart_and_a_check():
    """The device projected path opens one ``eigs.cycle`` a cycle, one
    ``eigs.restart`` a restart and one ``eigs.check`` a check, each check and
    restart inside its cycle and every cycle under the root ``eigs``; and
    its counters, the checks included, are those of a run with timing off."""
    run = _eigs_budget("device")
    timer.reset_counters()
    run()
    off = {**_counted(), "ritz_checks": timer.get_counter("ritz_checks")}
    _, recs = _traced(run)
    assert {**_counted(), "ritz_checks": timer.get_counter("ritz_checks")} == off
    [root] = _check_tree(recs)
    assert root.name == "eigs"
    counts = Counter(s.name for s in recs)
    assert counts["eigs.cycle"] == 4
    assert counts["eigs.restart"] == 3 == timer.get_counter("restarts.eigs.iram")
    assert counts["eigs.check"] == timer.get_counter("ritz_checks") > 4
    cycles = {s.id for s in recs if s.name == "eigs.cycle"}
    assert all(s.parent == root.id for s in recs if s.name == "eigs.cycle")
    assert all(s.parent in cycles for s in recs if s.name in ("eigs.check", "eigs.restart"))


def test_eigs_host_path_spans_each_restart():
    """The host projected path's restarts are ``eigs.restart`` spans too, one
    a restart, beside its ``eigs.projected_eig`` checks; it has no cycle or
    device check span."""
    _, recs = _traced(_eigs_budget("host"))
    [root] = _check_tree(recs)
    counts = Counter(s.name for s in recs)
    assert counts["eigs.restart"] == 3 and counts["eigs.projected_eig"] >= 4
    assert counts["eigs.cycle"] == counts["eigs.check"] == 0
    assert all(s.parent == root.id for s in recs if s.name == "eigs.restart")


def test_a_solve_is_one_root_and_the_next_another():
    _, recs = _traced(lambda: [RUNS["cg"]() for _ in range(2)])
    roots = _check_tree(recs)
    assert [r.name for r in roots] == ["cg", "cg"]
    assert roots[0].t1_ns <= roots[1].t0_ns
    assert Counter(s.root for s in recs) == Counter(
        {r.id: sum(s.root == r.id for s in recs) for r in roots})


def test_timing_off_records_nothing():
    RUNS["gmres-dcgs2"]()
    RUNS["cg"]()
    assert timer.spans() == []
    assert lt.timed("a", device=True) is lt.timed("b")  # one shared no-op bracket


def test_reset_counters_clears_spans():
    _, recs = _traced(RUNS["cg"])
    assert recs
    timer.reset_counters()
    assert timer.spans() == [] and timer.span_summary() == {}


def test_span_stamps_are_on_time_ns():
    before = time.time_ns()
    _, recs = _traced(RUNS["gmres-dcgs2"])
    after = time.time_ns()
    assert all(before <= s.t0_ns <= s.t1_ns <= after for s in recs)


def test_self_time_is_duration_less_children():
    lt.set_timing(True)
    try:
        with lt.timed("outer"):
            time.sleep(0.002)
            with lt.timed("inner"):
                time.sleep(0.003)
                with lt.timed("leaf"):
                    time.sleep(0.001)
            with lt.timed("inner"):
                time.sleep(0.001)
    finally:
        lt.set_timing(False)
    recs = timer.spans()
    dur = {s.id: s.t1_ns - s.t0_ns for s in recs}
    outer = next(s for s in recs if s.name == "outer")
    inners = [s for s in recs if s.name == "inner"]
    leaf = next(s for s in recs if s.name == "leaf")
    summary = timer.span_summary()
    assert summary["outer"]["count"] == 1 and summary["inner"]["count"] == 2
    assert summary["outer"]["self_host_s"] == pytest.approx(
        (dur[outer.id] - sum(dur[s.id] for s in inners)) * 1e-9)
    assert summary["inner"]["self_host_s"] == pytest.approx(
        (sum(dur[s.id] for s in inners) - dur[leaf.id]) * 1e-9)
    assert summary["leaf"]["self_host_s"] == pytest.approx(dur[leaf.id] * 1e-9)
    assert summary["outer"]["host_s"] == pytest.approx(dur[outer.id] * 1e-9)
    assert all(row["device_ms"] is None for row in summary.values())  # no card
    # a host span's timer takes its host time
    assert lt.global_watch.timer("leaf").etime == pytest.approx(dur[leaf.id] * 1e-9)


class _FakeEvent:
    """A timing CUDA event on a fake device clock: ``record`` stamps the
    clock, which advances a millisecond a call; ``query`` says whether the
    device has passed it (``done``)."""

    made = 0
    clock = 0.0
    done = True

    def __init__(self, device=None, enable_timing=False):
        assert enable_timing and device == "cuda"
        type(self).made += 1
        self.t = None
        self.waits = 0

    def record(self, stream=None):
        type(self).clock += 1.0
        self.t = type(self).clock

    def query(self):
        return type(self).done

    def synchronize(self):
        self.waits += 1

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def fake_card(monkeypatch):
    """CUDA in use, with fake events and a ``synchronize`` that fails."""
    def no_sync(*a, **k):
        raise AssertionError("a span synchronised with the device")

    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(_FakeEvent, "clock", 0.0)
    monkeypatch.setattr(_FakeEvent, "done", True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(timer, "_event_pool", [])
    yield _FakeEvent
    timer.reset_counters()  # read the fake events while they are patched in


def test_device_spans_make_no_synchronisation_and_reuse_events(fake_card):
    lt.global_watch.remove_timer("work")
    lt.set_timing(True)
    try:
        for _ in range(50):
            with lt.timed("work", device=True):
                with lt.timed("part", device=True):
                    pass
        RUNS["cg"]()
        # while the device lags, the spans take new events
        fake_card.done = False
        made = fake_card.made
        for _ in range(5):
            with lt.timed("lagging", device=True):
                pass
        assert fake_card.made > made
    finally:
        lt.set_timing(False)
    assert not any(e.waits for e in timer._pending[0]._events)  # nothing waited yet
    fake_card.done = True
    recs = timer.spans()
    assert all(s.device_ms is not None for s in recs if s.name != "host_read")
    # a span's device time spans its two events: the inner one's pair lies
    # inside, so the outer reads two more records of the fake clock
    parts = {s.parent: s.device_ms for s in recs if s.name == "part"}
    assert all(s.device_ms == parts[s.id] + 2.0 for s in recs
               if s.name == "work" and s.id in parts)
    assert made <= 8  # recycled, not one pair a span
    total = sum(s.device_ms for s in recs if s.name == "work")
    assert lt.global_watch.timer("work").etime == pytest.approx(total * 1e-3)
    assert lt.global_watch.timer("work").count == 50


def test_timed_fn_spans_are_device_timed(fake_card):
    _, recs = _traced(RUNS["cg"])
    root = next(s for s in recs if s.parent is None)
    assert root.name == "cg" and root.device_ms is not None
    assert all(s.device_ms is None for s in recs if s.name == "host_read")


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_span_event_time_matches_events_outside(cuda, monkeypatch):
    """A span around 200 stencil launches reads the device time that CUDA
    events recorded just outside it read, within 5%, and nothing inside
    synchronises."""
    op = lt.CudaPoisson2D(2048, dtype=torch.float32, device=cuda)
    u = torch.randn(2048, 2048, device=cuda)
    for _ in range(5):
        op.matvec(u)
    torch.cuda.synchronize()
    syncs = []
    real_sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: syncs.append(1))
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    lt.set_timing(True)
    try:
        a.record()
        with lt.timed("stencil_loop", device=True):
            for _ in range(200):
                op.matvec(u)
        b.record()
    finally:
        lt.set_timing(False)
    assert syncs == []
    monkeypatch.setattr(torch.cuda, "synchronize", real_sync)
    b.synchronize()
    span = next(s for s in timer.spans() if s.name == "stencil_loop")
    outside = a.elapsed_time(b)
    assert span.device_ms <= outside
    assert span.device_ms == pytest.approx(outside, rel=0.05)


@pytest.mark.cuda
def test_cuda_span_holds_its_launch_in_a_profiler_trace(cuda):
    """A span around one K1 launch contains that launch's ``cudaLaunchKernel``
    in a ``torch.profiler`` trace of device activity only, as the benchmark
    records it: the spans and the trace share the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    op = lt.CudaPoisson2D(1024, dtype=torch.float32, device=cuda)
    u = torch.randn(1024, 1024, device=cuda)
    op.matvec(u)
    torch.cuda.synchronize()
    lt.set_timing(True)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)
            with lt.timed("one_launch", device=True):
                op.matvec(u)
            time.sleep(0.01)
            torch.cuda.synchronize()
    finally:
        lt.set_timing(False)
    span = next(s for s in timer.spans() if s.name == "one_launch")
    launches = [(ev.start_ns(), ev.end_ns()) for ev in prof.profiler.kineto_results.events()
                if ev.device_type() != DeviceType.CUDA
                and ev.name() in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                                  "cuLaunchKernelEx")]
    inside = [(s, e) for s, e in launches if span.t0_ns <= s and e <= span.t1_ns]
    assert len(inside) >= 1, (span.t0_ns, span.t1_ns, launches)
