"""The port's device projected path against the JAX package's: the device
restarts (``iram_restart``, ``krylov_schur_device``), and ``eigs`` (single
and block), ``eighs`` and ``svds`` with ``projected="device"``, on the same
seeded operators and start vectors.

The counterparts of tests/test_hessenberg.py's driver cases and of
tests/test_block_eigs.py's device calls.  Both packages take their device
path here (the JAX package jitted on the CPU, the port through the kernels'
plain versions on CPU tensors).  The check cadence is pinned
(``check_every``) where two runs are compared step for step, since the
adaptive cadence reads the wall clock.  Tolerances: the closed-form or
dense-oracle gates of the JAX tests (100 ``tol`` for Toeplitz spectra, 1e-7
for converged eigenvalues, 1e-12 for factorization identities), and, between
the packages, the solve's own ``tolerance`` scaled as those tests scale it.
The exact-shift filter is forward-unstable in its discarded trailing block,
so restart-for-restart parity is held on invariants (the factorization, the
kept spectrum, the keep count), not on raw entries.
"""

import importlib

import numpy as np
import pytest
import torch

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch.convert import port_operator
from lightkrylov_tpu_torch.krylov.arnoldi import (arnoldi, arnoldi_block, initialize_arnoldi,
                                                  initialize_arnoldi_block)
from lightkrylov_tpu_torch.krylov.krylov_schur import (iram_restart, krylov_schur,
                                                       krylov_schur_device)
from lightkrylov_tpu_torch.utils import linalg as tla

eigs_mod = importlib.import_module("lightkrylov_tpu_torch.solvers.eigs")
torch.set_num_threads(2)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import lightkrylov_tpu as lk  # noqa: E402
from lightkrylov_tpu.models import TridiagToeplitz as JT  # noqa: E402
from lightkrylov_tpu.models import toeplitz_eigvals  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _multiset(a, b):
    d = np.abs(np.asarray(a)[:, None] - np.asarray(b)[None, :])
    return max(np.max(np.min(d, axis=0)), np.max(np.min(d, axis=1)))


def _spiral(rng, n):
    """A real matrix with a known well-separated complex spectrum
    (tests/test_block_eigs.py:30-49)."""
    D = np.zeros((n, n))
    for j in range(n // 2):
        r, th = 2.5 * 0.85 ** j, 0.3 + 2.1 * j
        a, b = r * np.cos(th), r * np.sin(th)
        D[2 * j, 2 * j] = D[2 * j + 1, 2 * j + 1] = a
        D[2 * j, 2 * j + 1], D[2 * j + 1, 2 * j] = b, -b
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return Q @ D @ Q.T


def _factorization(rng, N=64, kdim=16):
    Am = rng.standard_normal((N, N))
    op = lt.DenseOperator(torch.from_numpy(Am))
    X, H = initialize_arnoldi(torch.from_numpy(rng.standard_normal(N)), kdim)
    X, H, _ = arnoldi(op, X, H, kstart=1, kend=kdim)
    return Am, op, X, H


# -- the device restarts ------------------------------------------------------

def test_iram_restart_factorization_matches_jax(rng):
    """The IRAM restart keeps ``A X'[:, :n] = X'[:, :n+1] H'[:n+1, :n]``
    exactly, the basis orthonormal, the n largest-modulus Ritz values, the
    buffer invariant, and the JAX restart's keep count; ``n`` stays a 0-d
    tensor."""
    from lightkrylov_tpu.krylov.krylov_schur import iram_restart as j_iram

    Am, _, X, H = _factorization(rng)
    kdim = H.shape[1]
    Hh = H.numpy().copy()
    Xn, Hn, n, ok = iram_restart(X, H, kdim // 2)
    assert isinstance(n, torch.Tensor) and n.ndim == 0
    _, _, jn, jok = j_iram(jnp.asarray(X.numpy()), jnp.asarray(Hh), kdim // 2)
    n = int(n)
    assert n == int(jn) and bool(ok) and bool(jok)
    Xh, Hnh = Xn.numpy(), Hn.numpy()
    assert np.linalg.norm(Am @ Xh[:n].T - Xh[:n + 1].T @ Hnh[:n + 1, :n]) < 1e-12 * np.abs(Hh).max()
    assert np.linalg.norm(Xh[:n + 1] @ Xh[:n + 1].T - np.eye(n + 1)) < 1e-12
    wH = np.linalg.eigvals(Hh[:kdim, :kdim])
    assert _multiset(np.linalg.eigvals(Hnh[:n, :n]), wH[np.argsort(-np.abs(wH))][:n]) \
        < 1e-12 * np.abs(wH).max()
    assert np.all(Xh[n + 1:] == 0) and np.all(Hnh[:, n:] == 0)


def test_iram_restart_arrow_input_degrades_safely(rng):
    """On the arrow form the IRAM restart does not filter (``ok`` False) and
    truncates exactly, as the JAX restart does."""
    Am, op, X, H = _factorization(rng)
    kdim = H.shape[1]
    X, H, m = krylov_schur(X, H)
    X, H, _ = arnoldi(op, X, H, kstart=m + 1, kend=kdim)
    Xn, Hn, n, ok = iram_restart(X, H, kdim // 2)
    n = int(n)
    assert not bool(ok) and n >= m
    Xh, Hnh = Xn.numpy(), Hn.numpy()
    assert np.linalg.norm(Am @ Xh[:n].T - Xh[:n + 1].T @ Hnh[:n + 1, :n]) \
        < 1e-11 * np.abs(H.numpy()).max()
    assert np.linalg.norm(Xh[:n + 1] @ Xh[:n + 1].T - np.eye(n + 1)) < 1e-11


@pytest.mark.parametrize("arrow", [False, True])
def test_krylov_schur_device_matches_host_and_jax(arrow, rng):
    """The device Krylov-Schur restart on Hessenberg and arrow input: exact
    factorization, the host restart's and the JAX device restart's keep
    count and kept spectrum (BaseKrylov.fypp:714-837)."""
    from lightkrylov_tpu.krylov.krylov_schur import krylov_schur_device as j_ksd

    Am, op, X, H = _factorization(rng)
    kdim = H.shape[1]
    if arrow:
        X, H, m = krylov_schur(X, H)
        X, H, _ = arnoldi(op, X, H, kstart=m + 1, kend=kdim)
        assert np.any(np.tril(H.numpy()[:kdim, :kdim], -2) != 0)
    Hh, Xh0 = H.numpy().copy(), X.numpy().copy()
    w = np.linalg.eigvals(Hh[:kdim, :kdim])
    ws = w[np.argsort(-np.abs(w))]

    def select(v):
        return v.real > np.median(v.real)

    mask = select(ws)
    Xn, Hn, n, ok = krylov_schur_device(X, H, torch.from_numpy(ws.real.copy()),
                                        torch.from_numpy(ws.imag.copy()), torch.from_numpy(mask))
    n = int(n)
    assert bool(ok)
    Xh, Hnh = Xn.numpy(), Hn.numpy()
    assert np.linalg.norm(Am @ Xh[:n].T - Xh[:n + 1].T @ Hnh[:n + 1, :n]) < 1e-11 * np.abs(Hh).max()
    assert np.linalg.norm(Xh[:n + 1] @ Xh[:n + 1].T - np.eye(n + 1)) < 1e-11
    assert np.all(Xh[n + 1:] == 0) and np.all(Hnh[:, n:] == 0)
    _, H2, n2 = krylov_schur(X, H, select=select)
    _, jHn, jn, _ = j_ksd(jnp.asarray(Xh0), jnp.asarray(Hh), jnp.asarray(ws.real),
                          jnp.asarray(ws.imag), jnp.asarray(mask))
    assert n == n2 == int(jn)
    kept = np.linalg.eigvals(Hnh[:n, :n])
    assert _multiset(kept, np.linalg.eigvals(H2.numpy()[:n, :n])) < 1e-10
    assert _multiset(kept, np.linalg.eigvals(np.asarray(jHn)[:n, :n])) < 1e-10


@pytest.mark.parametrize("p", [2, 3])
def test_krylov_schur_device_block_restart(p, rng):
    """The block device restart (tests/test_block_eigs.py:123-164): the keep
    count leaves room to continue, the extended identity and orthonormality
    hold, and every kept value comes from the spectrum of ``H``."""
    n, kdim = 60, 12
    Am = rng.standard_normal((n, n))
    op = lt.DenseOperator(torch.from_numpy(Am))
    X, H = initialize_arnoldi_block(torch.from_numpy(rng.standard_normal(n)), kdim, p)
    X, H, _ = arnoldi_block(op, X, H, p)
    Hh = H.numpy().copy()
    w = np.linalg.eigvals(Hh[:kdim, :kdim])
    ws = w[np.argsort(-np.abs(w))]
    mask = np.abs(ws) > np.median(np.abs(ws))
    Xn, Hn, nk, ok = krylov_schur_device(X, H, torch.from_numpy(ws.real.copy()),
                                         torch.from_numpy(ws.imag.copy()),
                                         torch.from_numpy(mask), p=p)
    nk = int(nk)
    assert bool(ok) and 1 <= nk <= kdim - p
    Xh, Hnh = Xn.numpy(), Hn.numpy()
    assert np.linalg.norm(Am @ Xh[:nk].T - Xh[:nk + p].T @ Hnh[:nk + p, :nk]) \
        < 1e-10 * np.abs(Hh).max()
    assert np.linalg.norm(Xh[:nk + p] @ Xh[:nk + p].T - np.eye(nk + p)) < 1e-10
    assert np.all(Xh[nk + p:] == 0) and np.all(Hnh[:, nk:] == 0)
    w_kept = np.linalg.eigvals(Hnh[:nk, :nk])
    assert np.max(np.min(np.abs(w_kept[:, None] - w[None, :]), axis=1)) \
        < 1e-9 * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("p", [2, 3])
def test_krylov_schur_device_block_restart_matches_jax(p, rng):
    """The block device restart at ``k_eff < kdim`` (inactive identity
    positions in the Schur form, deselected before the reorder) against the
    JAX package's on the same buffer and selection: the same keep count and
    kept spectrum, the factorization exact."""
    from lightkrylov_tpu.krylov.krylov_schur import krylov_schur_device as j_ksd

    n, kdim, k = 60, 12, 10
    Am = rng.standard_normal((n, n))
    op = lt.DenseOperator(torch.from_numpy(Am))
    X, H = initialize_arnoldi_block(torch.from_numpy(rng.standard_normal(n)), kdim, p)
    X, H, _ = arnoldi_block(op, X, H, p)
    Hh, Xh0 = H.numpy().copy(), X.numpy().copy()
    w = np.linalg.eigvals(Hh[:k, :k])
    ws = np.concatenate([w[np.argsort(-np.abs(w))], np.zeros(kdim - k)])
    mask = np.concatenate([np.abs(ws[:k]) > np.median(np.abs(ws[:k])), np.zeros(kdim - k, bool)])
    args = [ws.real.copy(), ws.imag.copy(), mask]
    Xn, Hn, nk, ok = krylov_schur_device(X, H, *map(torch.from_numpy, args), p=p,
                                         k_eff=torch.tensor(k))
    _, jHn, jnk, jok = j_ksd(jnp.asarray(Xh0), jnp.asarray(Hh), *map(jnp.asarray, args), p=p,
                             k_eff=jnp.asarray(k))
    nk = int(nk)
    assert bool(ok) and bool(jok) and nk == int(jnk)
    Hnh = Hn.numpy()
    kept = np.linalg.eigvals(Hnh[:nk, :nk])
    assert _multiset(kept, np.linalg.eigvals(np.asarray(jHn)[:nk, :nk])) < 1e-10
    Xh = Xn.numpy()
    assert np.linalg.norm(Am @ Xh[:nk].T - Xh[:nk + p].T @ Hnh[:nk + p, :nk]) \
        < 1e-10 * np.abs(Hh).max()


def test_device_schur_restart_reorders_once_each(monkeypatch):
    """A custom-selector solve on the device path reorders once a device
    Schur restart, through ``ops.hessenberg.ordschur`` (on the card one
    launch of ``csrc/ordschur.cu``), and its span
    ``krylov_schur.ordschur_device`` counts each reorder while timing is on."""
    from lightkrylov_tpu_torch.ops import hessenberg as kernels

    calls = []
    plain = kernels.ordschur

    def counting(T, Z, sel):
        calls.append(T.shape[0])
        return plain(T, Z, sel)

    monkeypatch.setattr(kernels, "ordschur", counting)
    N = 128
    op = port_operator(JT(N, 2.0, -1.0, 1.0, dtype=np.float64))
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(N))
    span = lt.timer.global_watch.add_timer("krylov_schur.ordschur_device", "BaseKrylov")
    count0 = span.count
    lt.timer.reset_counters()
    lt.timer.set_timing(True)
    try:
        _, _, _, info, meta = lt.eigs(op, 6, x0=x0, kdim=16, tolerance=1e-9,
                                      select=lambda w: np.abs(w) > np.median(np.abs(w)),
                                      options=lt.EigsOptions(projected="device", maxiter=100))
    finally:
        lt.timer.set_timing(False)
    restarts = lt.timer.get_counter("restarts.eigs.schur_device")
    assert meta.converged and info == 6 and restarts > 0
    assert len(calls) == restarts == span.count - count0 and set(calls) == {16}
    assert lt.timer.get_counter("ordschur_reads") >= restarts  # the plain version's, on the CPU


# -- eigs ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_eigs_device_matches_jax(dtype):
    """``eigs(projected="device")`` on the Toeplitz fixture through IRAM
    restarts (TestIterativeSolvers.fypp:164-176): converged, each Ritz value
    within 100 tol of the closed form, the JAX device path's count and its
    matvecs within one sweep (tests/test_hessenberg.py:148-174), one host
    read a step and no QR host redo."""
    N, nev, kdim = 128, 6, 32
    jop = JT(N, 2.0, -1.0, 1.0, dtype=dtype)
    exact = toeplitz_eigvals(N, 2.0, -1.0, 1.0)
    tol = 1e-9 if dtype == np.float64 else 1e-5
    x0 = np.random.default_rng(1).standard_normal(N).astype(dtype)
    lt.timer.reset_counters()
    w, V, r, info, meta = lt.eigs(port_operator(jop), nev, x0=torch.from_numpy(x0), kdim=kdim,
                                  tolerance=tol, check_every=4,
                                  options=lt.EigsOptions(projected="device"))
    reads = lt.timer.get_counter("host_reads")
    jw, _, _, jinfo, jmeta = lk.eigs(jop, nev, x0=jnp.asarray(x0), kdim=kdim, tolerance=tol,
                                     check_every=4, options=lk.EigsOptions(projected="device"))
    assert meta.converged and info == jinfo == nev
    assert all(np.min(np.abs(exact - lam)) < 100 * tol for lam in w)
    assert _multiset(w, np.asarray(jw)) < 200 * tol
    assert abs(meta.n_iter - jmeta.n_iter) <= kdim
    assert lt.timer.get_counter("restarts.eigs.iram") > 0
    assert lt.timer.get_counter("qr_host_redos") == 0
    # a read a step but the sweep's last, a batched read a cycle, the start
    # vector's norm; one more when the last sweep stops at a converged check
    assert meta.n_iter + 1 <= reads <= meta.n_iter + 2


def test_eigs_device_ritz_vectors():
    """The device path's Ritz vectors diagonalize the operator."""
    N = 96
    jop = JT(N, 1.0, 1.0, -1.0, dtype=np.float64)
    op = port_operator(jop)
    x0 = np.random.default_rng(2).standard_normal(N)
    w, V, r, info, meta = lt.eigs(op, 4, x0=torch.from_numpy(x0), kdim=24, tolerance=1e-9,
                                  options=lt.EigsOptions(projected="device"))
    assert meta.converged
    A = np.asarray(jop.dense()).astype(complex)
    for i in range(4):
        v = V[i].numpy()
        assert np.linalg.norm(A @ v - w[i] * v) < 1e-7


def test_fused_sweep_check_stride():
    """A pinned cadence strides the checks; the converged eigenvalues match
    the default cadence's (tests/test_hessenberg.py:262-288)."""
    N = 128
    op = port_operator(JT(N, 2.0, -1.0, 1.0, dtype=np.float64))
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(N))
    outs = {}
    for ce in (None, 3):
        w, _, _, _, meta = lt.eigs(op, 4, x0=x0, kdim=24, tolerance=1e-9, check_every=ce,
                                   options=lt.EigsOptions(projected="device", maxiter=100))
        assert meta.converged
        outs[ce] = w
    assert _multiset(outs[3], outs[None]) < 1e-7


def test_eigs_custom_selector_stays_on_the_device(monkeypatch):
    """A custom selector restarts through the device Krylov-Schur path (host
    LAPACK's schur_select is never reached) and matches the host path's
    eigenvalues; its reorders are counted host reads."""
    N = 128
    op = port_operator(JT(N, 2.0, -1.0, 1.0, dtype=np.float64))
    exact = toeplitz_eigvals(N, 2.0, -1.0, 1.0)
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(N))

    def sel(w):
        return np.abs(w) > np.median(np.abs(w))

    def boom(*a, **k):
        raise AssertionError("host schur_select reached from the device path")

    results = {}
    for mode in ("host", "device"):
        if mode == "device":
            monkeypatch.setattr(tla, "schur_select", boom)
        lt.timer.reset_counters()
        w, _, _, _, meta = lt.eigs(op, 6, x0=x0, kdim=16, tolerance=1e-9, select=sel,
                                   options=lt.EigsOptions(projected=mode, maxiter=100))
        monkeypatch.undo()
        assert meta.converged
        assert all(np.min(np.abs(exact - lam)) < 1e-7 for lam in w)
        results[mode] = w
    assert lt.timer.get_counter("restarts.eigs.schur_device") > 0
    assert _multiset(results["device"], results["host"]) < 1e-7


def test_eigs_device_resume_from_arrow_checkpoint(tmp_path, monkeypatch):
    """A device solve resumed from a host checkpoint that holds the arrow
    form detects it and restarts through the device Schur path, without host
    LAPACK (tests/test_hessenberg.py:466-504)."""
    N = 128
    op = port_operator(JT(N, 2.0, -1.0, 1.0, dtype=np.float64))
    exact = toeplitz_eigvals(N, 2.0, -1.0, 1.0)
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal(N))
    ck = str(tmp_path / "eigs_arrow.npz")

    def sel(w):
        return np.abs(w) > np.median(np.abs(w))

    lt.eigs(op, 6, x0=x0, kdim=16, tolerance=1e-12, select=sel,
            options=lt.EigsOptions(projected="host", maxiter=3, checkpoint_every=1,
                                   checkpoint_path=ck))
    st = np.load(ck)
    hkey = [k for k in st.files if "'H'" in k][0]
    assert np.any(np.tril(st[hkey][:16, :16], -2) != 0)

    def boom(*a, **k):
        raise AssertionError("host schur_select reached on a device resume")

    monkeypatch.setattr(tla, "schur_select", boom)
    lt.timer.reset_counters()
    w, _, _, _, meta = lt.eigs(op, 6, x0=x0, kdim=16, tolerance=1e-9, select=sel,
                               options=lt.EigsOptions(projected="device", maxiter=100),
                               resume_from=ck)
    assert meta.converged
    assert all(np.min(np.abs(exact - lam)) < 1e-7 for lam in w)
    assert lt.timer.get_counter("restarts.eigs.iram") == 0


def test_eigs_device_checkpoint_reads_the_restart_index(tmp_path):
    """A due checkpoint after a device restart reads ``n`` to the host and
    stores a concrete ``kstart``; resuming from it on the device reproduces
    the uninterrupted run's eigenvalues."""
    N = 128
    op = port_operator(JT(N, 2.0, -1.0, 1.0, dtype=np.float64))
    x0 = torch.from_numpy(np.random.default_rng(6).standard_normal(N))
    ck = str(tmp_path / "dev.npz")
    opts = dict(projected="device", checkpoint_every=1, checkpoint_path=ck)
    w_full, _, _, _, meta = lt.eigs(op, 4, x0=x0, kdim=20, tolerance=1e-9, check_every=5,
                                    options=lt.EigsOptions(maxiter=60, **opts))
    assert meta.converged
    lt.eigs(op, 4, x0=x0, kdim=20, tolerance=1e-9, check_every=5,
            options=lt.EigsOptions(maxiter=2, **opts))
    st = np.load(ck)
    kstart = int(st[[k for k in st.files if "kstart" in k][0]])
    assert 1 < kstart <= 20
    w_res, _, _, _, meta_r = lt.eigs(op, 4, x0=x0, kdim=20, tolerance=1e-9, check_every=5,
                                     options=lt.EigsOptions(projected="device", maxiter=60),
                                     resume_from=ck)
    assert meta_r.converged
    assert _multiset(w_res, w_full) < 1e-7


def test_iram_failure_reroutes_to_the_device_schur_restart(monkeypatch):
    """Two truncation-only IRAM restarts in a row send the driver to the
    device Schur restart, which still converges (tests/test_hessenberg.py:
    507-541)."""
    N = 128
    op = port_operator(JT(N, 2.0, -1.0, 1.0, dtype=np.float64))
    exact = toeplitz_eigvals(N, 2.0, -1.0, 1.0)
    x0 = torch.from_numpy(np.random.default_rng(5).standard_normal(N))
    orig = eigs_mod.iram_restart
    calls = {"n": 0}

    def failing(X, H, n_target):
        calls["n"] += 1
        Xn, Hn, n, _ = orig(X, H, n_target)
        return Xn, Hn, n, torch.tensor(False)

    monkeypatch.setattr(eigs_mod, "iram_restart", failing)
    lt.timer.reset_counters()
    w, _, _, _, meta = lt.eigs(op, 6, x0=x0, kdim=16, tolerance=1e-9,
                               options=lt.EigsOptions(projected="device", maxiter=100))
    assert calls["n"] == 2
    assert lt.timer.get_counter("restarts.eigs.schur_device") > 0
    assert meta.converged
    assert all(np.min(np.abs(exact - lam)) < 1e-7 for lam in w)


def test_rejected_swap_reroutes_to_host_lapack(monkeypatch):
    """A rejected block swap in the device Schur restart sends the next
    restart to host LAPACK."""
    N = 128
    op = port_operator(JT(N, 2.0, -1.0, 1.0, dtype=np.float64))
    x0 = torch.from_numpy(np.random.default_rng(5).standard_normal(N))
    orig = eigs_mod.krylov_schur_device

    def rejecting(*a, **k):
        Xn, Hn, n, _ = orig(*a, **k)
        return Xn, Hn, n, torch.tensor(False)

    monkeypatch.setattr(eigs_mod, "krylov_schur_device", rejecting)
    lt.timer.reset_counters()
    _, _, _, _, meta = lt.eigs(op, 6, x0=x0, kdim=16, tolerance=1e-9,
                               select=lambda w: np.abs(w) > np.median(np.abs(w)),
                               options=lt.EigsOptions(projected="device", maxiter=100))
    assert meta.converged
    assert lt.timer.get_counter("restarts.eigs.schur_device") == 1
    assert lt.timer.get_counter("restarts.eigs.host") > 0


def test_qr_budget_redo_is_counted(monkeypatch):
    """A device check whose QR ran out of its budget is redone on the host
    and counted under ``qr_host_redos`` (the JAX package's eigs.py:533-543)."""
    real = eigs_mod.hessenberg_ritz

    def budget_out(*a, **k):
        out = real(*a, **k)
        return out[:6] + (torch.tensor(False),)

    monkeypatch.setattr(eigs_mod, "hessenberg_ritz", budget_out)
    op = port_operator(JT(64, 2.0, -1.0, 1.0, dtype=np.float64))
    x0 = torch.from_numpy(np.random.default_rng(8).standard_normal(64))
    lt.timer.reset_counters()
    w, _, r, info, meta = lt.eigs(op, 2, x0=x0, kdim=20, tolerance=1e-9,
                                  options=lt.EigsOptions(projected="device", maxiter=40))
    assert meta.converged and lt.timer.get_counter("qr_host_redos") > 0


def test_adaptive_stride_selection():
    """The cadence: a long stride when checks cost more than steps, per-step
    checks when steps dominate or checks are free (tests/test_hessenberg.py:
    544-577)."""
    a = eigs_mod._AdaptiveStride(40, "eigs")
    assert a.next_stride() == a.DEFAULT
    a.record(99.0, 40, a.DEFAULT)
    assert a.next_stride() == 1
    a.record(40 * (0.0005 + 0.020), 40, 1)
    assert a.next_stride() == 8
    a.record(40 * 0.0005 + 5 * 0.020, 40, 8)
    assert 30 <= a.next_stride() <= 40
    b = eigs_mod._AdaptiveStride(40, "eigs")
    b.record(99.0, 40, b.DEFAULT)
    b.record(40 * (0.055 + 0.020), 40, 1)
    b.record(40 * 0.055 + 5 * 0.020, 40, 8)
    assert b.next_stride() == 1
    c = eigs_mod._AdaptiveStride(40, "eigs")
    c.record(99.0, 40, c.DEFAULT)
    c.record(40 * 0.010, 40, 1)
    c.record(40 * 0.010, 40, 8)
    assert c.next_stride() == 1


def test_device_path_choice():
    """``"device"`` takes the device path for real dtypes; complex dtypes
    and ``"auto"`` take the host path, as the JAX package does off a TPU."""
    dev = lt.EigsOptions(projected="device")
    assert eigs_mod._device_projected(dev, torch.float32)
    assert not eigs_mod._device_projected(dev, torch.complex128)
    assert not eigs_mod._device_projected(lt.EigsOptions(), torch.float64)
    op = lt.TridiagToeplitz(40, 2.0, -1.0, 1.0, dtype=torch.complex128)
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal(40) + 0j)
    lt.timer.reset_counters()
    w, _, _, info, meta = lt.eigs(op, 2, x0=x0, kdim=20, tolerance=1e-9, options=dev)
    assert meta.converged
    assert not any(k.startswith("restarts.") for k in lt.timer._counters)


# -- eighs and svds -----------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_eighs_device_matches_jax(dtype):
    """``eighs(projected="device")`` through device thick restarts, against
    the closed form, the JAX device path (same matvec count at a pinned
    cadence) and its orthonormal Ritz vectors (tests/test_hessenberg.py:
    191-218)."""
    N, a, b = 128, 4.0, -1.0
    jop = JT(N, a, b, b, dtype=dtype)
    exact = np.sort(toeplitz_eigvals(N, a, b).real)[::-1]
    nev, kdim = 6, 32
    tol = 1e-9 if dtype == np.float64 else 1e-4
    x0 = np.random.default_rng(9).standard_normal(N).astype(dtype)
    w, V, r, info, meta = lt.eighs(port_operator(jop), nev, x0=torch.from_numpy(x0), kdim=kdim,
                                   tolerance=tol, check_every=4,
                                   options=lt.EigsOptions(projected="device", maxiter=80))
    jw, _, _, jinfo, jmeta = lk.eighs(jop, nev, x0=jnp.asarray(x0), kdim=kdim, tolerance=tol,
                                      check_every=4,
                                      options=lk.EigsOptions(projected="device", maxiter=80))
    assert meta.converged and info == jinfo
    assert meta.n_iter == jmeta.n_iter
    assert np.max(np.abs(w - exact[:nev]) / np.abs(exact[:nev])) < 10 * tol
    assert np.max(np.abs(w - np.asarray(jw))) < 100 * tol
    G = lt.gram(V).numpy()
    assert np.allclose(G, np.eye(nev), atol=1e-3 if dtype == np.float32 else 1e-8)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_svds_device_matches_jax(dtype, rng):
    """``svds(projected="device")`` against the dense SVD, the JAX device
    path (same matvec count) and the triplet residuals (tests/test_hessenberg
    .py:221-245)."""
    m, n = 96, 64
    Am = rng.standard_normal((m, n)).astype(dtype)
    sref = np.linalg.svd(Am.astype(np.float64), compute_uv=False)
    tol = 1e-10 if dtype == np.float64 else 1e-4
    u0 = rng.standard_normal(m).astype(dtype)
    U, S, V, res, info, meta = lt.svds(lt.DenseOperator(torch.from_numpy(Am)), 5,
                                       u0=torch.from_numpy(u0),
                                       v_template=torch.zeros(n, dtype=torch.from_numpy(Am).dtype),
                                       kdim=20, tolerance=tol, check_every=4,
                                       options=lt.SVDSOptions(projected="device", maxiter=40))
    jU, jS, jV, _, jinfo, jmeta = lk.svds(lk.DenseOperator(jnp.asarray(Am)), 5,
                                          u0=jnp.asarray(u0), v_template=jnp.zeros(n, dtype),
                                          kdim=20, tolerance=tol, check_every=4,
                                          options=lk.SVDSOptions(projected="device", maxiter=40))
    assert meta.converged and info == jinfo and meta.n_iter == jmeta.n_iter
    assert np.max(np.abs(S - sref[:5]) / sref[:5]) < 10 * tol
    assert np.max(np.abs(S - np.asarray(jS)) / sref[:5]) < 10 * tol
    for i in range(5):
        assert np.linalg.norm(Am @ V[i].numpy() - S[i] * U[i].numpy()) < 1e4 * tol * sref[0]
    # singular vectors match the JAX ones up to sign
    dots = np.abs(np.sum(U.numpy() * np.asarray(jU), axis=1))
    assert np.all(np.abs(dots - 1) < (1e-3 if dtype == np.float32 else 1e-8))


def test_device_thick_restart_paths(rng):
    """A small kdim forces device thick restarts of eighs and svds."""
    N = 96
    op = port_operator(JT(N, 4.0, -1.0, -1.0, dtype=np.float64))
    exact = np.sort(toeplitz_eigvals(N, 4.0, -1.0).real)[::-1]
    x0 = torch.from_numpy(np.random.default_rng(4).standard_normal(N))
    lt.timer.reset_counters()
    w, _, _, _, meta = lt.eighs(op, 4, x0=x0, kdim=10, tolerance=1e-9,
                                options=lt.EigsOptions(projected="device", maxiter=120))
    assert meta.converged and meta.n_iter > 10
    assert lt.timer.get_counter("restarts.eighs.thick_device") > 0
    assert np.max(np.abs(w - exact[:4]) / exact[:4]) < 1e-8
    Am = rng.standard_normal((80, 60))
    sref = np.linalg.svd(Am, compute_uv=False)
    U, S, V, _, _, smeta = lt.svds(lt.DenseOperator(torch.from_numpy(Am)), 3,
                                   u0=torch.from_numpy(rng.standard_normal(80)),
                                   v_template=torch.zeros(60, dtype=torch.float64), kdim=8,
                                   tolerance=1e-10,
                                   options=lt.SVDSOptions(projected="device", maxiter=120))
    assert smeta.converged and smeta.n_iter > 8
    assert lt.timer.get_counter("restarts.svds.thick_device") > 0
    assert np.max(np.abs(S - sref[:3]) / sref[:3]) < 1e-9


def test_final_recheck_sharpens_f32_floor(rng):
    """A float32 device solve with a tolerance below the float32 residual
    floor converges through the final float64 host recheck
    (tests/test_hessenberg.py:580-601)."""
    m = 48
    qa, _ = np.linalg.qr(rng.standard_normal((m, m)))
    qb, _ = np.linalg.qr(rng.standard_normal((m, m)))
    s_true = 3e3 * 0.5 ** np.arange(m)
    Am = ((qa * s_true) @ qb.T).astype(np.float32)
    U, S, V, res, info, meta = lt.svds(lt.DenseOperator(torch.from_numpy(Am)), 3,
                                       u0=torch.from_numpy(rng.standard_normal(m).astype(
                                           np.float32)),
                                       kdim=24, tolerance=1e-5,
                                       options=lt.SVDSOptions(projected="device", maxiter=6))
    assert info > 0 and meta.converged
    assert np.max(np.abs(S - s_true[:3]) / s_true[0]) < 1e-5


# -- block eigs ---------------------------------------------------------------

def test_block_eigs_device_matches_dense_and_jax(rng):
    """Block eigs on the device path without a restart
    (tests/test_block_eigs.py:167-187): the dense oracle's leading values,
    true eigenvectors, and the JAX block driver's values."""
    n, nev = 96, 4
    Am = rng.standard_normal((n, n))
    x0 = rng.standard_normal(n)
    w, V, r, info, meta = lt.eigs(lt.DenseOperator(torch.from_numpy(Am)), nev,
                                  x0=torch.from_numpy(x0), kdim=32, tolerance=1e-9, blksize=2,
                                  options=lt.EigsOptions(projected="device"))
    jw, _, _, jinfo, _ = lk.eigs(lk.DenseOperator(jnp.asarray(Am)), nev, x0=jnp.asarray(x0),
                                 kdim=32, tolerance=1e-9, blksize=2,
                                 options=lk.EigsOptions(projected="device"))
    assert info > 0 and meta.converged and info == jinfo
    w_ref = np.linalg.eigvals(Am)
    assert _multiset(w, w_ref[np.argsort(-np.abs(w_ref))][:nev]) < 1e-7
    assert _multiset(w, np.asarray(jw)) < 1e-7
    for j in range(nev):
        v = V[j].numpy()
        assert np.linalg.norm(Am @ v - w[j] * v) / np.linalg.norm(v) < 1e-6


def test_block_eigs_device_restarts_complex_spectrum(rng):
    """Device block Krylov-Schur restarts on a fully complex spectrum
    (tests/test_block_eigs.py:190-206)."""
    N, nev = 64, 4
    Am = _spiral(rng, N)
    w_all = np.linalg.eigvals(Am)
    exact = w_all[np.argsort(-np.abs(w_all))][:nev]
    lt.timer.reset_counters()
    w, _, _, info, meta = lt.eigs(lt.DenseOperator(torch.from_numpy(Am)), nev,
                                  x0=torch.from_numpy(rng.standard_normal(N)), kdim=10,
                                  tolerance=1e-9, blksize=2,
                                  options=lt.EigsOptions(projected="device", maxiter=30))
    assert info > 0 and meta.converged and meta.n_iter > 10
    assert lt.timer.get_counter("restarts.eigs-block.schur_device") > 0
    assert _multiset(w, exact) < 1e-7


def test_block_eigs_device_explicit_restart_fallback(rng, monkeypatch):
    """A rejected device block restart makes the next cycle restart
    explicitly from the leading Ritz direction; the driver still converges
    (tests/test_block_eigs.py:244-275)."""
    orig = eigs_mod.krylov_schur_device
    calls = {"n": 0}

    def flaky(X, H, wr, wi, mask, p=1, k_eff=None):
        out = orig(X, H, wr, wi, mask, p=p, k_eff=k_eff)
        calls["n"] += 1
        return out[:3] + ((torch.tensor(False),) if calls["n"] == 1 else (out[3],))

    monkeypatch.setattr(eigs_mod, "krylov_schur_device", flaky)
    N, nev = 64, 4
    Am = _spiral(rng, N)
    w_all = np.linalg.eigvals(Am)
    exact = w_all[np.argsort(-np.abs(w_all))][:nev]
    lt.timer.reset_counters()
    w, _, _, info, _ = lt.eigs(lt.DenseOperator(torch.from_numpy(Am)), nev,
                               x0=torch.from_numpy(rng.standard_normal(N)), kdim=10,
                               tolerance=1e-9, blksize=2,
                               options=lt.EigsOptions(projected="device", maxiter=40))
    assert calls["n"] >= 1 and info > 0
    assert lt.timer.get_counter("restarts.eigs-block.explicit") == 1
    assert _multiset(w, exact) < 1e-7


def test_block_eigs_device_matches_blksize1():
    """Block size 3 and 1 on the device path find the same leading values
    (tests/test_block_eigs.py:209-228)."""
    N, nev = 96, 4
    op = port_operator(JT(N, 2.0, -1.0, 1.0, dtype=np.float64))
    x0 = torch.from_numpy(np.random.default_rng(7).standard_normal(N))
    opts = lt.EigsOptions(projected="device", maxiter=40)
    w1, _, _, info1, _ = lt.eigs(op, nev, x0=x0, kdim=36, tolerance=1e-9, options=opts)
    w3, _, _, info3, _ = lt.eigs(op, nev, x0=x0, kdim=36, tolerance=1e-9, blksize=3,
                                 options=opts)
    assert info1 > 0 and info3 > 0
    assert _multiset(w1, w3) < 1e-7
