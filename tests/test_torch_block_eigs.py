"""The port's block ``eigs(blksize=p)`` and block Krylov-Schur restart
against the JAX package's, on the operators of tests/test_block_eigs.py.

The JAX block driver runs its fused device sweep and device Schur restarts
on every backend; the port runs block sweeps with host checks and the host
restart ``krylov_schur_block``.  The initial block also comes from different
generators (a JAX key, a torch generator), so the trajectories differ and
the two are held to their converged results, not to step counts: Ritz
values within 1e-7 (as tests/test_block_eigs.py holds the JAX driver),
Ritz-vector residuals below 1e-6, all in float64.  The restart is held to
the JAX device restart on the same factorization: the same keep count, an
exact factorization and orthonormal basis to 1e-10.  The reference defects
the port copies (ROADMAP F2, F5, F8) are pinned here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightkrylov_tpu as lk
import lightkrylov_tpu_torch as lt
from lightkrylov_tpu.models import TridiagToeplitz as JToeplitz
from lightkrylov_tpu_torch.convert import port_operator
from lightkrylov_tpu_torch.krylov.arnoldi import arnoldi_block, initialize_arnoldi_block
from lightkrylov_tpu_torch.krylov.krylov_schur import krylov_schur_block
from lightkrylov_tpu_torch.utils import timer

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


def _dense(seed, n):
    return np.random.default_rng(seed).standard_normal((n, n))


def _spiral(seed, n):
    """A real matrix with a known, well-separated complex spectrum: 2x2
    rotation-scaling blocks with geometric radii, conjugated by an
    orthogonal matrix (tests/test_block_eigs.py:31-49)."""
    rng = np.random.default_rng(seed)
    D = np.zeros((n, n))
    for j in range(n // 2):
        r, th = 2.5 * 0.85 ** j, 0.3 + 2.1 * j
        a, b = r * np.cos(th), r * np.sin(th)
        D[2 * j, 2 * j] = D[2 * j + 1, 2 * j + 1] = a
        D[2 * j, 2 * j + 1], D[2 * j + 1, 2 * j] = b, -b
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return Q @ D @ Q.T


def _leading(Am, nev):
    w = np.linalg.eigvals(Am)
    return w[np.argsort(-np.abs(w))][:nev]


def _multiset_dist(a, b):
    d = np.abs(np.asarray(a)[:, None] - np.asarray(b)[None, :])
    return max(d.min(0).max(), d.min(1).max())


def _both(Am, nev, x0, **kw):
    """The same block eigs call in each package (the JAX one as
    tests/test_block_eigs.py calls it)."""
    jopts = kw.pop("jax_options", {})
    ref = lk.eigs(lk.DenseOperator(jnp.asarray(Am)), nev, x0=jnp.asarray(x0),
                  options=lk.EigsOptions(projected="device", **jopts), **kw)
    got = lt.eigs(lt.DenseOperator(torch.from_numpy(Am)), nev, x0=torch.from_numpy(x0),
                  options=lt.EigsOptions(**jopts), **kw)
    return ref, got


def test_block_eigs_dense_matches_jax_and_dense():
    """tests/test_block_eigs.py:167-187: the dense 96, kdim 32, blksize 2."""
    n, nev = 96, 4
    Am = _dense(7, n)
    x0 = np.random.default_rng(8).standard_normal(n)
    (wj, _, _, infoj, metaj), (wt, Vt, rt, infot, metat) = _both(
        Am, nev, x0, kdim=32, tolerance=1e-9, blksize=2)
    assert infoj > 0 and infot > 0 and metat.converged
    assert wt.dtype == np.complex128 and rt.dtype == np.float64
    exact = _leading(Am, nev)
    assert _multiset_dist(wt, exact) < 1e-7
    assert _multiset_dist(wt, np.asarray(wj)) < 1e-7
    assert Vt.shape == (nev, n) and Vt.dtype == torch.complex128
    V = Vt.numpy()
    for j in range(nev):
        assert np.linalg.norm(Am @ V[j] - wt[j] * V[j]) / np.linalg.norm(V[j]) < 1e-6
    assert np.all(rt < 1e-9)
    assert metat.n_iter % 2 == 0 and len(metat.residuals) > 0


def test_block_eigs_restarts_on_a_complex_spectrum():
    """tests/test_block_eigs.py:190-206: kdim 10 forces block restarts on a
    fully complex spectrum; exact keep counts around conjugate pairs."""
    N, nev = 64, 4
    Am = _spiral(9, N)
    x0 = np.random.default_rng(10).standard_normal(N)
    (wj, _, _, infoj, _), (wt, _, _, infot, metat) = _both(
        Am, nev, x0, kdim=10, tolerance=1e-9, blksize=2, jax_options=dict(maxiter=30))
    exact = _leading(Am, nev)
    assert infoj > 0 and infot > 0 and metat.converged
    assert metat.n_iter > 10  # at least one restart happened
    assert np.max(np.abs(np.sort_complex(wt) - np.sort_complex(exact))) < 1e-7
    assert _multiset_dist(wt, np.asarray(wj)) < 1e-7


def test_block_eigs_matches_blksize1_on_toeplitz():
    """tests/test_block_eigs.py:209-228: TridiagToeplitz(96) at blksize 3
    against blksize 1, a multiset match (nev 4 keeps the leading set
    pair-aligned)."""
    N, nev = 96, 4
    jop = JToeplitz(N, 2.0, -1.0, 1.0, dtype=jnp.float64)
    op = port_operator(jop)
    x0 = np.random.default_rng(11).standard_normal(N)
    kw = dict(kdim=36, tolerance=1e-9, options=lt.EigsOptions(maxiter=40))
    w1, _, _, info1, _ = lt.eigs(op, nev, x0=torch.from_numpy(x0), **kw)
    w3, _, _, info3, meta3 = lt.eigs(op, nev, x0=torch.from_numpy(x0), blksize=3, **kw)
    wj, _, _, infoj, _ = lk.eigs(jop, nev, x0=jnp.asarray(x0), kdim=36, tolerance=1e-9,
                                 blksize=3, options=lk.EigsOptions(projected="device",
                                                                   maxiter=40))
    assert info1 > 0 and info3 > 0 and infoj > 0
    assert meta3.n_iter % 3 == 0
    assert _multiset_dist(w1, w3) < 1e-7
    assert _multiset_dist(w3, np.asarray(wj)) < 1e-7


def test_block_eigs_check_every_and_counts():
    """``check_every`` counts block steps: per-step checks stop the sweep at
    the first converged check, in no more matvecs than one check a sweep;
    the applications are counted on the operator, and ``matvec_counter``
    sees the same number through the block form."""
    N, nev = 64, 4
    Am = _spiral(12, N)
    x0 = torch.from_numpy(np.random.default_rng(13).standard_normal(N))
    op = lt.DenseOperator(torch.from_numpy(Am))
    exact = _leading(Am, nev)
    timer.reset_counters()
    counted = timer.matvec_counter(op, "Spiral")
    w0, _, _, info0, meta0 = lt.eigs(counted, nev, x0=x0, kdim=24, tolerance=1e-9, blksize=2)
    assert timer.get_counter("Spiral.matvec") == meta0.n_iter
    assert timer.get_counter(f"{timer.operator_label(counted)}.matvec") == meta0.n_iter
    w1, _, _, info1, meta1 = lt.eigs(op, nev, x0=x0, kdim=24, tolerance=1e-9, blksize=2,
                                     check_every=1)
    assert info0 > 0 and info1 > 0
    assert meta1.n_iter <= meta0.n_iter
    assert _multiset_dist(w0, exact) < 1e-7 and _multiset_dist(w1, exact) < 1e-7


def test_block_eigs_through_the_stencil_operator_matches_jax():
    """The slice as a whole on the CPU: block eigs on ``CudaPoisson2D``
    (its block form is the batched stencil's plain version) against the JAX
    block driver on ``Poisson2D``, and both against the closed form."""
    from lightkrylov_tpu.models import Poisson2D, poisson2d_eigvals

    nx, ny, nev = 16, 12, 4
    x0 = np.random.default_rng(14).standard_normal((ny, nx))
    exact = np.sort(poisson2d_eigvals(nx, ny))[::-1][:nev]
    op = lt.CudaPoisson2D(nx, ny, dtype=torch.float64)
    wt, Vt, _, infot, metat = lt.eigs(op, nev, x0=torch.from_numpy(x0), kdim=40,
                                      tolerance=1e-10, blksize=2,
                                      options=lt.EigsOptions(maxiter=60))
    wj, _, _, infoj, _ = lk.eigs(Poisson2D(nx, ny), nev, x0=jnp.asarray(x0), kdim=40,
                                 tolerance=1e-10, blksize=2,
                                 options=lk.EigsOptions(projected="device", maxiter=60))
    assert infot > 0 and infoj > 0
    assert Vt.shape == (nev, ny, nx)
    assert np.max(np.abs(np.sort(wt.real)[::-1] - exact)) < 1e-7 * exact[0]
    assert np.max(np.abs(wt.imag)) < 1e-7 * exact[0]
    assert _multiset_dist(wt, np.asarray(wj)) < 1e-7 * exact[0]


# -- the guards (F5) -----------------------------------------------------------


def test_block_eigs_guards_match_jax(tmp_path):
    """Block mode is real-only and refuses checkpoints, in both packages
    (tests/test_block_eigs.py:231-241, ROADMAP F5); the port also refuses
    ``resume_from``.  ``projected="device"`` runs the device block driver,
    the JAX package's only block driver, to the JAX driver's values."""
    N = 16
    jop = JToeplitz(N, 2.0, -1.0, 1.0, dtype=jnp.float64)
    op = port_operator(jop)
    x = np.random.default_rng(15).standard_normal(N)
    ck = dict(checkpoint_every=1, checkpoint_path=str(tmp_path / "x.npz"))
    for run, mod, arr in ((lambda *a, **k: lk.eigs(jop, *a, **k), lk, jnp.asarray),
                          (lambda *a, **k: lt.eigs(op, *a, **k), lt, torch.from_numpy)):
        with pytest.raises(TypeError):
            run(2, x0=arr(x.astype(np.complex128)), blksize=2)
        with pytest.raises(NotImplementedError):
            run(2, x0=arr(x), blksize=2, options=mod.EigsOptions(**ck))
    with pytest.raises(NotImplementedError):
        lt.eigs(op, 2, x0=torch.from_numpy(x), blksize=2, resume_from=str(tmp_path / "x.npz"))
    w, _, _, info, _ = lt.eigs(op, 2, x0=torch.from_numpy(x), kdim=12, tolerance=1e-9,
                               blksize=2, options=lt.EigsOptions(projected="device", maxiter=60))
    jw, _, _, jinfo, _ = lk.eigs(jop, 2, x0=jnp.asarray(x), kdim=12, tolerance=1e-9, blksize=2,
                                 options=lk.EigsOptions(projected="device", maxiter=60))
    assert info == jinfo == 2
    d = np.abs(w[:, None] - np.asarray(jw)[None, :])
    assert max(d.min(axis=0).max(), d.min(axis=1).max()) < 1e-7


# -- the restart ----------------------------------------------------------------


def _block_factorization(p, n=60, kdim=12, seed=4):
    Am = _dense(seed, n)
    op = lt.DenseOperator(torch.from_numpy(Am))
    x0 = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(n))
    X, H = initialize_arnoldi_block(x0, kdim, p)
    X, H, info = arnoldi_block(op, X, H, p)
    assert int(info) == 0
    return Am, X, H


def _check_restarted(Am, X, H, Xn, Hn, n, p):
    Xh, Hh, Hnh, Xnh = X.numpy(), H.numpy(), Hn.numpy(), Xn.numpy()
    r = np.linalg.norm(Am @ Xnh[:n].T - Xnh[:n + p].T @ Hnh[:n + p, :n])
    assert r < 1e-10 * np.abs(Hh).max()
    G = Xnh[:n + p] @ Xnh[:n + p].T
    assert np.linalg.norm(G - np.eye(n + p)) < 1e-10
    assert np.all(Xnh[n + p:] == 0) and np.all(Hnh[:, n:] == 0)
    # unchanged inputs
    assert not np.shares_memory(Xnh, Xh)


@pytest.mark.parametrize("p", [2, 3])
def test_block_restart_matches_jax_device_restart(p):
    """tests/test_block_eigs.py:123-164: the median selection; the same
    keep count as the JAX device restart, an exact factorization, kept
    values drawn from the selected ones."""
    from lightkrylov_tpu.krylov.krylov_schur import krylov_schur_device

    Am, X, H = _block_factorization(p)
    kdim = H.shape[1]
    Hh = H.numpy()
    w = np.linalg.eigvals(Hh[:kdim, :kdim])
    ws = w[np.argsort(-np.abs(w))]
    mask = np.abs(ws) > np.median(np.abs(ws))
    _, _, nj, okj = krylov_schur_device(jnp.asarray(X.numpy()), jnp.asarray(Hh),
                                        jnp.asarray(ws.real), jnp.asarray(ws.imag),
                                        jnp.asarray(mask), p=p)
    Xn, Hn, n, ok = krylov_schur_block(X, H, lt.median_selector, p, kdim)
    assert ok and bool(okj) and n == int(nj)
    assert 1 <= n <= kdim - p
    _check_restarted(Am, X, H, Xn, Hn, n, p)
    kept = np.linalg.eigvals(Hn.numpy()[:n, :n])
    assert _multiset_dist(kept, ws[mask][:n]) < 1e-9 * np.abs(w).max()


def test_block_restart_never_splits_a_pair():
    """ROADMAP F8: keeping every value at p = 3, kdim = 12 clamps the keep
    count to kdim - p = 9; where positions 8-9 of the Schur form hold a
    conjugate pair, the device rule keeps 8, as the JAX device restart does
    (the host blksize-1 clamp would keep 9 and split the pair).  Over start
    vectors, every restart keeps the JAX count and a set closed under
    conjugation, and the rule fires at least once."""
    from lightkrylov_tpu.krylov.krylov_schur import krylov_schur_device

    p, kdim, n0 = 3, 12, 60
    Am = _spiral(16, n0)
    op = lt.DenseOperator(torch.from_numpy(Am))
    keep_all = lambda vals: np.ones(len(vals), bool)  # noqa: E731
    fired = 0
    for seed in range(12):
        x0 = torch.from_numpy(np.random.default_rng(100 + seed).standard_normal(n0))
        X, H = initialize_arnoldi_block(x0, kdim, p)
        X, H, _ = arnoldi_block(op, X, H, p)
        Hh = H.numpy()
        w = np.linalg.eigvals(Hh[:kdim, :kdim])
        _, _, nj, _ = krylov_schur_device(jnp.asarray(X.numpy()), jnp.asarray(Hh),
                                          jnp.asarray(w.real), jnp.asarray(w.imag),
                                          jnp.asarray(np.ones(kdim, bool)), p=p)
        Xn, Hn, n, ok = krylov_schur_block(X, H, keep_all, p, kdim)
        assert ok and n == int(nj) and n in (kdim - p, kdim - p - 1)
        fired += n == kdim - p - 1
        kept = np.linalg.eigvals(Hn.numpy()[:n, :n])
        assert _multiset_dist(kept, np.conj(kept)) < 1e-9  # no pair split
        _check_restarted(Am, X, H, Xn, Hn, n, p)
    assert fired >= 1


def test_block_restart_at_a_short_active_square():
    """After an offset continuation the sweep stops short of kdim: the
    restart works on ``H[:k_eff, :k_eff]`` and reads the coupling block and
    residual columns at ``k_eff``, as the JAX device restart does."""
    from lightkrylov_tpu.krylov.krylov_schur import krylov_schur_device

    p, kdim, n0 = 2, 12, 50
    Am = _dense(18, n0)
    op = lt.DenseOperator(torch.from_numpy(Am))
    x0 = torch.from_numpy(np.random.default_rng(19).standard_normal(n0))
    X, H = initialize_arnoldi_block(x0, kdim, p)
    X, H, _ = arnoldi_block(op, X, H, p, kend=10)  # k_eff = 10 < kdim
    k_eff = 10
    Hh = H.numpy()
    w = np.linalg.eigvals(Hh[:k_eff, :k_eff])
    ws = w[np.argsort(-np.abs(w))]
    mask = np.zeros(kdim, bool)
    mask[:k_eff] = np.abs(ws) > np.median(np.abs(ws))
    sel_wr = np.zeros(kdim)
    sel_wi = np.zeros(kdim)
    sel_wr[:k_eff], sel_wi[:k_eff] = ws.real, ws.imag
    _, _, nj, _ = krylov_schur_device(jnp.asarray(X.numpy()), jnp.asarray(Hh),
                                      jnp.asarray(sel_wr), jnp.asarray(sel_wi),
                                      jnp.asarray(mask), p=p, k_eff=jnp.asarray(k_eff))
    Xn, Hn, n, ok = krylov_schur_block(X, H, lt.median_selector, p, k_eff)
    assert ok and n == int(nj) <= k_eff - 1
    _check_restarted(Am, X, H, Xn, Hn, n, p)


def test_block_eigs_explicit_restart_fallback(monkeypatch):
    """tests/test_block_eigs.py:244-273: one rejected reorder makes the
    driver restart explicitly from the leading Ritz direction, and it still
    converges to the exact values (ROADMAP F4: the reseed has no bound of
    its own, only ``maxiter``)."""
    import importlib

    eigs_mod = importlib.import_module("lightkrylov_tpu_torch.solvers.eigs")
    orig = eigs_mod.krylov_schur_block
    calls = {"n": 0}

    def flaky(X, H, select, p, k_eff):
        Xn, Hn, n, ok = orig(X, H, select, p, k_eff)
        calls["n"] += 1
        return Xn, Hn, n, ok and calls["n"] != 1

    monkeypatch.setattr(eigs_mod, "krylov_schur_block", flaky)
    N, nev = 64, 4
    Am = _spiral(20, N)
    x0 = torch.from_numpy(np.random.default_rng(21).standard_normal(N))
    w, _, _, info, meta = lt.eigs(lt.DenseOperator(torch.from_numpy(Am)), nev, x0=x0, kdim=10,
                                  tolerance=1e-9, blksize=2, options=lt.EigsOptions(maxiter=40))
    assert calls["n"] >= 2
    assert info > 0
    assert np.max(np.abs(np.sort_complex(w) - np.sort_complex(_leading(Am, nev)))) < 1e-7


def test_block_breakdown_returns_converged_as_jax_does():
    """ROADMAP F2: a start vector in a one-dimensional invariant subspace
    breaks the first block down in one column; both packages then return
    ``converged`` after one block step, although the other Ritz pairs are
    far from converged."""
    n, nev = 40, 4
    d = np.linspace(1.0, 4.0, n)
    Am = np.diag(d)
    x0 = np.zeros(n)
    x0[-1] = 1.0  # an eigenvector
    (wj, _, rj, infoj, metaj), (wt, _, rt, infot, metat) = _both(
        Am, nev, x0, kdim=12, tolerance=1e-10, blksize=2)
    assert metaj.converged and metat.converged
    assert infoj > 0 and infot > 0
    assert metat.n_iter == metaj.n_iter == 2
    assert np.min(np.abs(wt - 4.0)) < 1e-12
