"""The port's device projected eigensolve (lightkrylov_tpu_torch.utils.hessenberg
and its kernels' wrappers, lightkrylov_tpu_torch.ops.hessenberg) against the
JAX package's lightkrylov_tpu.utils.hessenberg, LAPACK, and, on a GPU, the
CUDA kernels against their plain versions.

The counterparts of tests/test_hessenberg.py's unit cases: the same seeded
numpy matrices go through the JAX function (jitted, on the CPU) and the
port's (whose wrappers take the plain version on a CPU tensor).  Eigenvalues
are compared as multisets.  Tolerances: the JAX package's own LAPACK gates
of tests/test_hessenberg.py (1e-11 of the spectrum's scale in float64, 1e-4
in float32) for eigenvalues, ``rtol`` of lightkrylov_tpu/constants.py
(3.2e-8 in float64) for what the two packages compute along different but
equally exact paths (residuals, kept Ritz values), and 1e-12 (float64) for
factorization identities ``Z T Z^T = H`` and ``Z^T Z = I``.

The tests marked ``cuda`` compare each CUDA kernel with its plain version and
skip where there is no GPU; they import no JAX, so on a machine with a GPU and
no JAX they run with ``python -m pytest --noconftest -m cuda
tests/test_torch_hessenberg.py``.
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch.ops import hessenberg as kernels
from lightkrylov_tpu_torch.utils import hessenberg as H

torch.set_num_threads(2)

RTOL64 = 3.162277660168379e-08  # lightkrylov_tpu.constants.rtol(float64)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


@pytest.fixture
def J():
    """The JAX package's hessenberg module (imported here, so that the
    ``cuda`` tests need no JAX)."""
    from lightkrylov_tpu.utils import hessenberg

    return hessenberg


@pytest.fixture
def jnp():
    import jax.numpy

    return jax.numpy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _w(wr, wi):
    return np.asarray(wr, np.float64) + 1j * np.asarray(wi, np.float64)


def _match(a, b):
    """Largest distance between two multisets of complex numbers, matched
    one to one."""
    a, b = np.asarray(a), np.asarray(b)
    if len(a) == 0:
        return 0.0
    cost = np.abs(a[:, None] - b[None, :])
    r, c = linear_sum_assignment(cost)
    return float(cost[r, c].max())


# -- hessenberg_eigvals -------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5, 17, 40])
def test_eigvals_match_jax_and_lapack(n, rng, J, jnp):
    A = np.triu(rng.standard_normal((n, n)), -1)
    wr, wi, ok = H.hessenberg_eigvals(torch.from_numpy(A))
    jwr, jwi, jok = J.hessenberg_eigvals(jnp.asarray(A))
    assert bool(ok) and bool(jok)
    w, w_ref = _w(wr, wi), np.linalg.eigvals(A)
    scale = max(1.0, np.abs(w_ref).max())
    assert _match(w, w_ref) < 1e-11 * scale
    assert _match(w, _w(jwr, jwi)) < 1e-11 * scale


def test_eigvals_f32(rng, J, jnp):
    A = np.triu(rng.standard_normal((24, 24)).astype(np.float32), -1)
    wr, wi, ok = H.hessenberg_eigvals(torch.from_numpy(A))
    assert bool(ok) and wr.dtype == torch.float32
    w_ref = np.linalg.eigvals(A.astype(np.float64))
    assert _match(_w(wr, wi), w_ref) < 1e-4 * np.abs(w_ref).max()
    jwr, jwi, _ = J.hessenberg_eigvals(jnp.asarray(A))
    assert _match(_w(wr, wi), _w(jwr, jwi)) < 1e-4 * np.abs(w_ref).max()


def test_eigvals_non_hessenberg_input(rng):
    """A dense input (the Krylov-Schur arrow form is one) goes through the
    Householder reduction first."""
    A = rng.standard_normal((20, 20))
    wr, wi, ok = H.hessenberg_eigvals(torch.from_numpy(A))
    w_ref = np.linalg.eigvals(A)
    assert bool(ok)
    assert _match(_w(wr, wi), w_ref) < 1e-11 * np.abs(w_ref).max()


def test_eigvals_dynamic_keff(rng, J, jnp):
    """``k_eff`` as an int and as a 0-d tensor: the active block's spectrum,
    inactive slots exactly zero, as the JAX function reports them."""
    n = 24
    A = np.triu(rng.standard_normal((n, n)), -1)
    for k in (1, 2, 7, 15, 24):
        for kk in (k, torch.tensor(k)):
            wr, wi, ok = H.hessenberg_eigvals(torch.from_numpy(A), kk)
            w_ref = np.linalg.eigvals(A[:k, :k])
            assert bool(ok)
            assert _match(_w(wr, wi)[:k], w_ref) < 1e-11 * max(1.0, np.abs(w_ref).max())
            assert np.all(wr.numpy()[k:] == 0) and np.all(wi.numpy()[k:] == 0)
        jwr, _, _ = J.hessenberg_eigvals(jnp.asarray(A), k)
        assert np.all(np.asarray(jwr)[k:] == 0)


def test_complex_input_raises():
    A = torch.eye(4, dtype=torch.complex128)
    for fn in (H.hessenberg_eigvals, H.schur_real):
        with pytest.raises(TypeError, match="real-only"):
            fn(A)


# -- eigenvectors and the Ritz check ------------------------------------------

def test_eigvecs_inverse_iteration(rng, J, jnp):
    n = 30
    A = np.triu(rng.standard_normal((n, n)), -1)
    wr, wi, _ = H.hessenberg_eigvals(torch.from_numpy(A))
    Vr, Vi = H.hessenberg_eigvecs(torch.from_numpy(A), wr, wi)
    V, w = Vr.numpy() + 1j * Vi.numpy(), _w(wr, wi)
    for j in range(n):
        assert np.linalg.norm(A @ V[:, j] - w[j] * V[:, j]) < 1e-10
        assert abs(np.linalg.norm(V[:, j]) - 1.0) < 1e-12
    # the JAX function's vectors span the same eigenvectors (up to a phase)
    jVr, jVi = J.hessenberg_eigvecs(jnp.asarray(A), jnp.asarray(wr.numpy()),
                                    jnp.asarray(wi.numpy()))
    jV = np.asarray(jVr) + 1j * np.asarray(jVi)
    overlap = np.abs(np.sum(np.conj(jV) * V, axis=0))
    assert np.all(np.abs(overlap - 1.0) < RTOL64)


@pytest.mark.parametrize("k_eff", [3, 9, 20])
def test_ritz_matches_jax_and_host(k_eff, rng, J, jnp):
    """A check's Ritz values, residuals and converged count equal the JAX
    device check's and the host path's ``eig``; the order is modulus-
    descending."""
    kdim, tol = 20, 0.5
    He = np.zeros((kdim + 1, kdim))
    He[:k_eff + 1, :k_eff] = np.triu(rng.standard_normal((k_eff + 1, k_eff)), -1)
    wr, wi, res, Vr, Vi, n_conv, ok = H.hessenberg_ritz(torch.from_numpy(He), k_eff, tol)
    jwr, jwi, jres, _, _, jn, jok = J.hessenberg_ritz(jnp.asarray(He), k_eff, tol)
    assert bool(ok) and bool(jok)
    w_d, r_d = _w(wr, wi)[:k_eff], res.numpy()[:k_eff]
    w_h, V_h = np.linalg.eig(He[:k_eff, :k_eff])
    r_h = abs(He[k_eff, k_eff - 1]) * np.abs(V_h[-1, :])
    assert _match(w_d, w_h) < 1e-10
    assert np.max(np.abs(np.sort(r_d) - np.sort(r_h))) < 1e-10
    assert _match(w_d, _w(jwr, jwi)[:k_eff]) < 1e-10
    assert np.max(np.abs(np.sort(r_d) - np.sort(np.asarray(jres)[:k_eff]))) < RTOL64
    assert int(n_conv) == int(jn) == int(np.sum(r_h < tol))
    assert np.all(np.diff(np.abs(w_d)) <= 1e-12)
    assert np.all(np.isinf(res.numpy()[k_eff:]))


def test_ritz_invariant_subspace(rng):
    """beta = 0: every active residual is exactly zero."""
    kdim, k_eff = 10, 6
    He = np.zeros((kdim + 1, kdim))
    He[:k_eff, :k_eff] = np.triu(rng.standard_normal((k_eff, k_eff)), -1)
    _, _, res, _, _, n_conv, ok = H.hessenberg_ritz(torch.from_numpy(He), torch.tensor(k_eff),
                                                    1e-12)
    assert bool(ok)
    assert np.all(res.numpy()[:k_eff] == 0) and int(n_conv) == k_eff


def test_ritz_block_residuals_match_jax(rng, J, jnp):
    """``p = 2``: the block residual ``||B y_last||`` of a band-Hessenberg
    buffer, against the JAX check and the host formula."""
    kdim, p, k_eff, tol = 12, 2, 10, 0.3
    He = np.zeros((kdim + p, kdim))
    He[:k_eff + p, :k_eff] = np.triu(rng.standard_normal((k_eff + p, k_eff)), -p)
    wr, wi, res, _, _, n_conv, ok = H.hessenberg_ritz(torch.from_numpy(He), k_eff, tol, nev=4,
                                                      p=p)
    jwr, jwi, jres, _, _, jn, _ = J.hessenberg_ritz(jnp.asarray(He), k_eff, tol, nev=4, p=p)
    w_h, V_h = np.linalg.eig(He[:k_eff, :k_eff])
    r_h = np.linalg.norm(He[k_eff:k_eff + p, k_eff - p:k_eff] @ V_h[-p:, :], axis=0)
    assert bool(ok)
    assert _match(_w(wr, wi)[:k_eff], w_h) < 1e-10
    assert np.max(np.abs(np.sort(res.numpy()[:k_eff]) - np.sort(r_h))) < 1e-10
    assert np.max(np.abs(np.sort(res.numpy()[:k_eff])
                         - np.sort(np.asarray(jres)[:k_eff]))) < RTOL64
    assert int(n_conv) == int(jn)


# -- Schur form, reordering, the IRAM filter ----------------------------------

@pytest.mark.parametrize("n", [2, 5, 12, 24, 40, 120, 257])
def test_schur_real_factorization(n, rng, J, jnp):
    """``H = Z T Z^T`` with ``Z`` orthogonal, ``T`` quasi-triangular with
    every 2x2 block a conjugate pair, and the JAX function's eigenvalues.
    n = 120 puts the plain version where the kernel's ``Z`` leaves shared
    memory in float64, n = 257 where a kernel thread owns two rows."""
    A = rng.standard_normal((n, n))
    T, Z, wr, wi, ok = H.schur_real(torch.from_numpy(A))
    T, Z = T.numpy(), Z.numpy()
    assert bool(ok)
    assert np.linalg.norm(Z @ T @ Z.T - A) < 1e-12 * max(1, np.linalg.norm(A))
    assert np.linalg.norm(Z.T @ Z - np.eye(n)) < 1e-12
    assert np.all(np.abs(np.tril(T, -2)) == 0)
    for i in np.flatnonzero(np.diag(T, -1)):
        blk = T[i:i + 2, i:i + 2]
        assert ((blk[0, 0] - blk[1, 1]) / 2) ** 2 + blk[0, 1] * blk[1, 0] < 0
    _, _, jwr, jwi, _ = J.schur_real(jnp.asarray(A))
    scale = max(1.0, np.abs(np.linalg.eigvals(A)).max())
    assert _match(_w(wr, wi), _w(jwr, jwi)) < 1e-10 * scale


def test_ordschur_device_matches_jax(rng, J, jnp):
    """The selected eigenvalues lead (TRSEN, Utils.fypp:37-60), the
    factorization stays exact, the mask is made pair-consistent, the JAX
    function keeps the same count and spectrum, and each block swap costs
    one counted host read."""
    for n in (6, 13, 24):
        A = rng.standard_normal((n, n))
        T, Z, wr, wi, _ = H.schur_real(torch.from_numpy(A))
        jT, jZ, _, _, _ = J.schur_real(jnp.asarray(A))
        for _ in range(3):
            mask = rng.random(n) < 0.4
            lt.timer.reset_counters()
            T2, Z2, sel2, ok2 = H.ordschur_device(T, Z, torch.from_numpy(mask))
            reads = lt.timer.get_counter("host_reads")
            jT2, _, jsel2, jok2 = J.ordschur_device(jT, jZ, jnp.asarray(mask))
            T2, Z2, sel2 = T2.numpy(), Z2.numpy(), sel2.numpy()
            ns = int(sel2.sum())
            assert bool(ok2) and bool(jok2)
            assert ns == int(np.asarray(jsel2).sum())
            assert np.all(sel2[:ns]) and not np.any(sel2[ns:])
            assert np.linalg.norm(Z2 @ T2 @ Z2.T - A) < 1e-12 * np.linalg.norm(A)
            assert np.linalg.norm(Z2.T @ Z2 - np.eye(n)) < 1e-12
            if ns:
                assert _match(np.linalg.eigvals(T2[:ns, :ns]),
                              np.linalg.eigvals(np.asarray(jT2)[:ns, :ns])) < 1e-9
            assert reads >= 1


@pytest.mark.parametrize("kdim", [16, 24])
def test_francis_filter_matches_jax(kdim, rng, J, jnp):
    """The exact-shift filter: the same keep count and flag as the JAX
    function, ``Hf = Z^T H Z`` with ``Z`` orthogonal, and the kept block's
    spectrum the ``n`` largest-modulus eigenvalues (the JAX function's
    kept block's too)."""
    A = np.triu(rng.standard_normal((kdim, kdim)), -1)
    Hf, Z, n, ok = H.francis_filter(torch.from_numpy(A), kdim // 2)
    jHf, _, jn, jok = J.francis_filter(jnp.asarray(A), kdim // 2)
    n, Hf, Z = int(n), Hf.numpy(), Z.numpy()
    assert n == int(jn) and bool(ok) == bool(jok) is True
    assert np.linalg.norm(Z.T @ A @ Z - Hf) < 1e-12 * np.linalg.norm(A)
    assert np.linalg.norm(Z.T @ Z - np.eye(kdim)) < 1e-12
    w = np.linalg.eigvals(A)
    lead = w[np.argsort(-np.abs(w))][:n]
    assert _match(np.linalg.eigvals(Hf[:n, :n]), lead) < 1e-8
    assert _match(np.linalg.eigvals(np.asarray(jHf)[:n, :n]), lead) < 1e-8


def test_francis_filter_arrow_input_applies_no_sweep(rng):
    """On a matrix that is not Hessenberg the filter applies no sweep (a pure
    truncation) and reports ``ok = False``."""
    A = np.triu(rng.standard_normal((12, 12)), -1)
    A[8, 2] = 0.5
    Hf, Z, n, ok = H.francis_filter(torch.from_numpy(A), 6)
    assert not bool(ok)
    assert np.array_equal(Z.numpy(), np.eye(12)) and np.array_equal(Hf.numpy(), A)


# -- the kernels' wrappers on the CPU ------------------------------------------

def test_wrappers_take_the_plain_version_on_the_cpu(rng):
    """On a CPU tensor each wrapper computes its plain version and counts no
    launch."""
    A = torch.from_numpy(np.triu(rng.standard_normal((9, 9)), -1))
    before = (kernels.hessenberg_schur.LAUNCHES, kernels.francis_filter_sweeps.LAUNCHES)
    got = kernels.hessenberg_schur(A, 7, with_z=True, split=True)
    want = kernels.hessenberg_schur_reference(A, 7, True, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    wr, wi = got[2], got[3]
    order = torch.argsort(-(wr * wr + wi * wi), stable=True)
    Hf, Z, work = kernels.francis_filter_sweeps(A, wr, wi, order, 4, True)
    Hf2, Z2, work2 = kernels.francis_filter_sweeps_reference(A, wr, wi, order, torch.tensor(4),
                                                             torch.tensor(True))
    assert torch.equal(Hf, Hf2) and torch.equal(Z, Z2) and torch.equal(work, work2)
    assert 0 < int(work[0]) <= int(work[1])
    assert before == (kernels.hessenberg_schur.LAUNCHES, kernels.francis_filter_sweeps.LAUNCHES)


def test_schur_budget_flag_and_sweep_count(rng):
    """``ok`` and the work of the plain Schur core: a converged run spends
    fewer than the 30 n budget and at most 13 chase steps a sweep; the 2x2
    blocks it accepts are reported."""
    A = torch.from_numpy(rng.standard_normal((15, 15)))
    T, Z, wr, wi, acc, ok, work = kernels.hessenberg_schur(A)
    sweeps, steps = (int(v) for v in work)
    n_pairs = int((wi.numpy() > 0).sum())
    assert bool(ok) and 0 < sweeps < 30 * 15 and 0 < steps <= 13 * sweeps and Z is None
    assert int(acc.sum()) >= n_pairs  # real-pair blocks are accepted too
    T, Z, wr, wi, acc, ok, _ = kernels.hessenberg_schur(A, with_z=True, split=True)
    assert bool(ok) and int(acc.sum()) == n_pairs  # split: conjugate pairs only


def test_chase_sums_its_small_products_in_a_fixed_order():
    """The plain chase's small products are ordered elementwise sums, each
    product and each sum rounded on its own, ``(p0 r0 + p1 r1) + p2 r2`` and
    ``c u + s v`` (the order ``csrc/hessenberg.cu`` repeats), not a matrix
    product whose order the library picks: a chase over a window of four
    rows (two steps and the closing rotation) on a seeded float64 Hessenberg
    is bit-equal to the same sums in numpy."""
    n, lo, hi = 7, 1, 4
    rng = np.random.default_rng(11)
    A = np.triu(rng.standard_normal((n, n)), -1)
    s, t = np.float64(0.7), np.float64(-0.4)
    Ht, Zt = torch.from_numpy(A.copy()), torch.eye(n, dtype=torch.float64)
    assert H._chase(Ht, lo, hi, s, t, Zt) == hi - lo - 1

    def rows(M, R):  # row r: ((M[r,0] R[0] + M[r,1] R[1]) + M[r,2] R[2])
        out = M[:, 0:1] * R[0]
        for k in range(1, M.shape[1]):
            out = out + M[:, k:k + 1] * R[k]
        return out

    Hn, Zn = A.copy(), np.eye(n)
    h00, h01, h10, h11, h21 = Hn[lo, lo], Hn[lo, lo + 1], Hn[lo + 1, lo], Hn[lo + 1, lo + 1], \
        Hn[lo + 2, lo + 1]
    x, y, z = h00 * h00 + h01 * h10 - s * h00 + t, h10 * (h00 + h11 - s), h10 * h21
    for p in range(lo, hi - 1):
        if p > lo:
            x, y, z = Hn[p:p + 3, p - 1]
        P = H._householder3(x, y, z)
        Hn[p:p + 3, :] = rows(P, Hn[p:p + 3, :])
        Hn[:, p:p + 3] = rows(P.T, Hn[:, p:p + 3].T).T
        Zn[:, p:p + 3] = rows(P.T, Zn[:, p:p + 3].T).T
        if p > lo:
            Hn[p + 1:p + 3, p - 1] = 0.0
    x, y = Hn[hi - 1:hi + 1, hi - 2]
    r = np.sqrt(x * x + y * y)
    G = np.array([[x / r, y / r], [-y / r, x / r]])
    Hn[hi - 1:hi + 1, :] = rows(G, Hn[hi - 1:hi + 1, :])
    Hn[:, hi - 1:hi + 1] = rows(G, Hn[:, hi - 1:hi + 1].T).T
    Zn[:, hi - 1:hi + 1] = rows(G, Zn[:, hi - 1:hi + 1].T).T
    Hn[hi, hi - 2] = 0.0
    assert np.array_equal(Ht.numpy(), Hn) and np.array_equal(Zt.numpy(), Zn)


@pytest.mark.parametrize("case", ["f64-tiny", "f32-arnoldi300"])
def test_schur_scales_vectors_too_small_to_square(case, J, jnp):
    """A reflector's or rotation's vector whose squares would underflow is
    scaled by a power of two first (``_pow2_scaled``, and ``pow2_exp`` in the
    kernel), which leaves every larger vector's arithmetic as it was.  On a
    float64 Hessenberg of size 2^-300 the first vector of a chase (~2^-600)
    squares to nothing; on the float32 Hessenberg of an eigs check at kdim
    300 (entries down to 1e-17) the bottom windows' first vectors do.  The
    plain Schur core converges to numpy's eigenvalues in both; the JAX
    package, which scales nothing, runs out of its sweep budget on the
    second (ROADMAP F10: the port differs on purpose)."""
    if case == "f64-tiny":
        A = np.triu(np.random.default_rng(5).standard_normal((24, 24)), -1) * 2.0 ** -300
        tol = 1e-11
    else:
        A = _arnoldi_hessenberg(300, 300, 512).astype(np.float32)
        tol = 1e-5
        _, _, jok = J.hessenberg_eigvals(jnp.asarray(A))
        assert not bool(jok)
    wr, wi, ok = H.hessenberg_eigvals(torch.from_numpy(A))
    Ad = A.astype(np.float64)
    assert bool(ok)
    assert _match(_w(wr, wi), np.linalg.eigvals(Ad)) < tol * np.linalg.norm(Ad)


# -- ROADMAP F3 ---------------------------------------------------------------

def test_f3_mask_transfer_matches_jax(J, jnp):
    """F3, copied from the JAX package (krylov_schur.py:176-181): each Schur
    position takes the flag of its nearest selection entry by value, and the
    zero-filled tail of ``sel_wr``/``sel_wi`` (flags False) is a candidate.
    An eigenvalue of 1e-15 whose checked value reads 3e-15 is nearer to the
    tail's 0 than to its own entry, so it is deselected although the
    selector kept it: both packages keep 3, not 4."""
    from lightkrylov_tpu.krylov.krylov_schur import krylov_schur_device as j_ksd
    from lightkrylov_tpu_torch.krylov.krylov_schur import krylov_schur_device

    kdim, N = 6, 10
    rng = np.random.default_rng(7)
    Q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    X = np.zeros((kdim + 1, N))
    X[:kdim + 1] = Q[:kdim + 1]
    Hm = np.zeros((kdim + 1, kdim))
    Hm[:kdim, :kdim] = np.diag([3.0, 2.0, 1.0, 1e-15, 0.5, 0.25]) + np.triu(
        0.1 * rng.standard_normal((kdim, kdim)), 1)
    Hm[kdim, kdim - 1] = 0.1
    sel_wr = np.array([3.0, 2.0, 1.0, 0.5, 0.25, 3e-15, 0.0, 0.0])  # tail zero-filled
    sel_wi = np.zeros(8)
    mask = np.array([True, True, True, False, False, True, False, False])
    _, Hn, n, ok = krylov_schur_device(torch.from_numpy(X), torch.from_numpy(Hm),
                                       torch.from_numpy(sel_wr), torch.from_numpy(sel_wi),
                                       torch.from_numpy(mask))
    _, jHn, jn, jok = j_ksd(jnp.asarray(X), jnp.asarray(Hm), jnp.asarray(sel_wr),
                            jnp.asarray(sel_wi), jnp.asarray(mask))
    assert int(n) == int(jn) == 3 and bool(ok) and bool(jok)
    kept = np.sort(np.linalg.eigvals(Hn.numpy()[:3, :3]).real)
    assert np.allclose(kept, [1.0, 2.0, 3.0], atol=1e-12)
    assert np.allclose(np.sort(np.linalg.eigvals(np.asarray(jHn)[:3, :3]).real), kept,
                       atol=1e-12)


# -- the launch geometry (pure Python) ----------------------------------------

_BUDGET = kernels.SMEM_LIMIT - kernels.SMEM_RESERVED


@pytest.mark.parametrize("n, itemsize, with_z, h_smem, z_smem", [
    (119, 8, True, True, True), (120, 8, True, True, False),
    (169, 4, True, True, True), (170, 4, True, True, False),
    (169, 8, False, True, False), (170, 8, False, False, False),
    (239, 4, False, True, False), (240, 4, False, False, False),
    (200, 8, True, False, False), (40, 8, True, True, True), (30, 8, True, True, True),
    # with Z, f32 and f64, at every edge the kernels' gates run
    (119, 4, True, True, True), (120, 4, True, True, True),
    (169, 8, True, True, False), (170, 8, True, False, False),
    (239, 4, True, True, False), (239, 8, True, False, False),
    (240, 4, True, False, False), (240, 8, True, False, False),
    (241, 4, True, False, False), (241, 8, True, False, False),
    (256, 4, True, False, False), (256, 8, True, False, False),
    (257, 4, True, False, False), (257, 8, True, False, False),
    (300, 4, True, False, False), (300, 8, True, False, False)])
def test_geometry_places_h_and_z_by_the_shared_memory_limit(n, itemsize, with_z, h_smem,
                                                            z_smem):
    """Each matrix in shared memory exactly when its padded rows (stride
    ``n | 1``) fit beside the Schur kernel's vectors in the 232,448 bytes a
    CTA may have, less the kernels' static scalars."""
    assert kernels.SMEM_LIMIT == 232448
    g = kernels.geometry(n, itemsize, with_z)
    assert (g.h_smem, g.z_smem) == (h_smem, z_smem)
    mat = n * (n | 1) * itemsize
    vec = n * itemsize + 4 * n
    assert g.smem_bytes == vec + mat * (h_smem + z_smem) <= _BUDGET
    if not h_smem:
        assert mat + vec > _BUDGET
    elif with_z and not z_smem:
        assert 2 * mat + vec > _BUDGET


@pytest.mark.parametrize("n, itemsize, h_smem, z_smem", [
    (119, 8, True, True), (120, 8, True, False), (169, 8, True, False), (170, 8, False, False),
    (169, 4, True, True), (170, 4, True, False),
    (119, 4, True, True), (120, 4, True, True), (239, 4, True, False), (240, 4, True, False),
    (241, 4, False, False), (256, 4, False, False), (257, 4, False, False),
    (300, 4, False, False), (240, 8, False, False), (257, 8, False, False),
    (300, 8, False, False)])
def test_geometry_of_the_filter(n, itemsize, h_smem, z_smem):
    """The filter keeps no vectors: ``H`` and ``Z`` alone, so in float32 ``H``
    stays in shared memory one size further than in the Schur kernel
    (n = 240)."""
    g = kernels.geometry(n, itemsize, True, schur=False)
    assert (g.h_smem, g.z_smem) == (h_smem, z_smem)
    assert g.smem_bytes == n * (n | 1) * itemsize * (h_smem + z_smem) <= _BUDGET


@pytest.mark.parametrize("n, warps, rows", [
    (1, 1, 1), (3, 1, 1), (31, 1, 1), (32, 1, 1), (33, 2, 1), (64, 2, 1), (65, 3, 1),
    (128, 4, 1), (200, 7, 1), (256, 8, 1), (400, 8, 2),
    (119, 4, 1), (120, 4, 1), (169, 6, 1), (170, 6, 1), (239, 8, 1), (240, 8, 1), (241, 8, 1),
    (257, 8, 2), (300, 8, 2)])
def test_geometry_warps(n, warps, rows):
    """A thread a row or column, at most 8 warps: from n = 257 a thread owns
    ``rows`` rows or columns (the kernels' ``g + G`` loops)."""
    for itemsize in (4, 8):
        for schur in (True, False):
            g = kernels.geometry(n, itemsize, True, schur=schur)
            assert g.warps == warps
            assert -(-n // (32 * g.warps)) == rows


# -- the CUDA kernels (need a GPU) --------------------------------------------

KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-11}  # of ||H||_F, as chip_smoke.py
SCHUR_ORTH = {torch.float32: 1e-5, torch.float64: 1e-12}  # 2-norms, as chip_smoke.py


# n: the warp counts' edges (31-33, 64-65), Z in shared memory on both sides
# of its limit (119/120 in f64, 169/170 in f32), H alone on both sides of its
# limit (169/170 in f64, 239/240 in f32), H in global memory (200, 256), and a
# thread owning two rows or columns (257, 300)
KERNEL_NS = [3, 17, 31, 32, 33, 40, 64, 65, 119, 120, 169, 170, 200, 239, 240, 256, 257, 300]


def _hold_schur_to_plain(cuda, dtype, A, k, with_z=True):
    """One launch of the Schur kernel on ``A`` against its plain version:
    eigenvalues within ``KERNEL_TOL`` of ``||A||_F`` of the plain version's
    and numpy's, the factorization and ``Z``'s orthogonality (with ``Z``),
    and on a Hessenberg input the same ``[sweeps, chase steps]`` as the plain
    version's: both sum each small product in the order the plain version
    writes."""
    n = A.shape[0]
    Ht = torch.from_numpy(A).to(cuda, dtype)
    before = kernels.hessenberg_schur.LAUNCHES
    T, Z, wr, wi, acc, ok, work = kernels.hessenberg_schur(Ht, k, with_z=with_z, split=with_z)
    torch.cuda.synchronize()
    assert kernels.hessenberg_schur.LAUNCHES == before + 1
    assert acc.dtype == ok.dtype == torch.bool and work.dtype == torch.int32
    _, _, pwr, pwi, _, pok, pwork = kernels.hessenberg_schur_reference(Ht, k, with_z, with_z)
    norm = float(np.linalg.norm(A))
    assert bool(ok) and bool(pok)
    w = _w(wr.cpu(), wi.cpu())[:k]
    assert _match(w, _w(pwr.cpu(), pwi.cpu())[:k]) < KERNEL_TOL[dtype] * norm
    Ad = Ht.double().cpu().numpy()[:k, :k]
    assert _match(w, np.linalg.eigvals(Ad)) < KERNEL_TOL[dtype] * norm
    if not np.tril(A, -2).any():
        assert work.tolist() == pwork.tolist()
    if not with_z:
        return
    He = np.zeros_like(A)
    He[:k, :k] = A[:k, :k]
    Hm = H._embed(torch.from_numpy(He), k)[0].numpy()
    T, Z = T.double().cpu().numpy(), Z.double().cpu().numpy()
    assert np.linalg.norm(Z @ T @ Z.T - Hm, 2) < SCHUR_ORTH[dtype] * np.linalg.norm(Hm, 2)
    assert np.linalg.norm(Z.T @ Z - np.eye(n), 2) < SCHUR_ORTH[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", KERNEL_NS)
def test_cuda_schur_kernel_matches_plain(cuda, dtype, n):
    A = np.triu(np.random.default_rng(n).standard_normal((n, n)), -1)
    _hold_schur_to_plain(cuda, dtype, A, n - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [239, 240, 256, 257, 300])
def test_cuda_schur_kernel_arnoldi_hessenberg(cuda, dtype, n):
    """The Hessenberg an eigs check sees at large kdim: deflation early and
    often, beside the random Hessenbergs of KERNEL_NS."""
    _hold_schur_to_plain(cuda, dtype, _arnoldi_hessenberg(n, n, 512), n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [33, 65, 120])
def test_cuda_schur_kernel_eigenvalues_only(cuda, dtype, n):
    """Without ``Z`` the kernel keeps ``H`` alone in shared memory."""
    A = np.triu(np.random.default_rng(n + 1).standard_normal((n, n)), -1)
    _hold_schur_to_plain(cuda, dtype, A, n, with_z=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_schur_kernel_zero_diagonal(cuda, dtype):
    """A zero diagonal: the deflation test's zero-neighbour safeguard reads
    max |H| in the first sweeps."""
    A = np.triu(np.random.default_rng(5).standard_normal((24, 24)), -1)
    np.fill_diagonal(A, 0.0)
    _hold_schur_to_plain(cuda, dtype, A, 24)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_schur_kernel_exceptional_shift(cuda, dtype):
    """The cyclic shift, on which the Wilkinson shifts stall: it converges
    only through the exceptional shift of every tenth stalled sweep."""
    A = np.zeros((4, 4))
    A[np.arange(1, 4), np.arange(3)] = 1.0
    A[0, 3] = 1.0
    work = H._schur_plain(torch.from_numpy(A), 4, False, False)[6]
    assert int(work[0]) > 10
    _hold_schur_to_plain(cuda, dtype, A, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_schur_kernel_tiny_scale(cuda, dtype):
    """A Hessenberg so small (2^-33 in f32, 2^-300 in f64) that a chase's
    first vector squares to nothing unscaled: the kernel scales it as the
    plain version does (``pow2_exp``), and takes the same sweeps."""
    tiny = 2.0 ** (-33 if dtype == torch.float32 else -300)
    A = np.triu(np.random.default_rng(5).standard_normal((24, 24)), -1) * tiny
    _hold_schur_to_plain(cuda, dtype, A, 24)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_schur_kernel_keff_tensors(cuda, dtype):
    """``k_eff < n`` given as an int32 and an int64 tensor on the card, which
    the kernel reads where it lies."""
    A = np.triu(np.random.default_rng(9).standard_normal((40, 40)), -1)
    Ht = torch.from_numpy(A).to(cuda, dtype)
    want = kernels.hessenberg_schur(Ht, 29)
    for kt in (torch.tensor(29, dtype=torch.int32, device=cuda),
               torch.tensor(29, dtype=torch.int64, device=cuda)):
        got = kernels.hessenberg_schur(Ht, kt)
        for a, b in zip(got, want):
            if a is not None:
                assert torch.equal(a, b)


def _arnoldi_hessenberg(kdim, seed, n=256, real=None):
    """The square Arnoldi Hessenberg of a matrix of order ``n`` with a known,
    well-separated complex spectrum (chip_smoke.py's input for the filter),
    with ``real`` one more, real eigenvalue: the exact-shift filter is
    forward-unstable on a random non-normal Hessenberg, so kernel and plain
    version agree there only up to that instability."""
    rng = np.random.default_rng(seed)
    m = n + (real is not None)
    D = np.zeros((m, m))
    for j in range(n // 2):
        r, th = 2.5 * 0.85 ** j, 0.3 + 2.1 * j
        a, b = r * np.cos(th), r * np.sin(th)
        D[2 * j:2 * j + 2, 2 * j:2 * j + 2] = [[a, b], [-b, a]]
    if real is not None:
        D[n, n] = real
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    A = Q @ D @ Q.T
    n = m
    V = np.zeros((n, kdim + 1))
    H = np.zeros((kdim + 1, kdim))
    v = rng.standard_normal(n)
    V[:, 0] = v / np.linalg.norm(v)
    for k in range(kdim):
        w = A @ V[:, k]
        for _ in range(2):
            h = V[:, :k + 1].T @ w
            w -= V[:, :k + 1] @ h
            H[:k + 1, k] += h
        H[k + 1, k] = np.linalg.norm(w)
        V[:, k + 1] = w / H[k + 1, k]
    return H[:kdim, :kdim]


FILTER_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}  # of ||H||_F, as chip_smoke.py


def _filter_input(kdim, seed):
    """The filter's input at ``kdim`` (chip_smoke.py filter_hessenberg): an
    operator of order 512 beyond kdim 128, and for an odd kdim a real
    dominant eigenvalue, without which every odd keep count splits a
    conjugate pair and the filter applies no sweep."""
    return _arnoldi_hessenberg(kdim, seed, 256 if kdim <= 128 else 512,
                               3.0 if kdim % 2 else None)


# the filter's edges: Z leaves shared memory (120 in f64, 170 in f32), H does
# (170 in f64, 241 in f32), a thread owns two rows (257, 300)
FILTER_NS = [40, 64, 119, 120, 169, 170, 240, 241, 256, 257, 300]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kdim", FILTER_NS)
def test_cuda_filter_kernel_matches_plain(cuda, dtype, kdim):
    A = _filter_input(kdim, 1)
    Ht = torch.from_numpy(A).to(cuda, dtype)
    wr, wi, order, n, pure, ok = H._filter_shifts(Ht, kdim // 2)
    before = kernels.francis_filter_sweeps.LAUNCHES
    Hf, Z, work = kernels.francis_filter_sweeps(Ht, wr, wi, order, n, pure)
    torch.cuda.synchronize()
    assert kernels.francis_filter_sweeps.LAUNCHES == before + 1
    Hp, _, pwork = kernels.francis_filter_sweeps_reference(Ht, wr, wi, order, n, pure)
    n = int(n)
    assert bool(ok & pure) and int(work[0]) == int(pwork[0]) > 0
    Hd = Ht.double().cpu().numpy()
    norm = np.linalg.norm(Hd)
    Hf, Z = Hf.double().cpu().numpy(), Z.double().cpu().numpy()
    assert np.linalg.norm(Z.T @ Hd @ Z - Hf, 2) < SCHUR_ORTH[dtype] * np.linalg.norm(Hd, 2)
    assert np.linalg.norm(Z.T @ Z - np.eye(kdim), 2) < SCHUR_ORTH[dtype]
    kept = np.linalg.eigvals(Hf[:n, :n])
    assert _match(kept, np.linalg.eigvals(Hp.double().cpu().numpy()[:n, :n])) < \
        FILTER_TOL[dtype] * norm
    w = np.linalg.eigvals(Hd)
    assert _match(kept, w[np.argsort(-np.abs(w))][:n]) < FILTER_TOL[dtype] * norm


def _bits(t):
    """``t`` as integers of its width, so that ``torch.equal`` compares bits
    (``-0.0`` and ``0.0`` differ)."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _bit_equal(got, want):
    return all((a is None and b is None) or torch.equal(_bits(a), _bits(b))
               for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("with_z", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [33, 40, 65, 120, 200, 257, 300])
def test_cuda_schur_lagging_warp_build_is_bit_equal(cuda, n, dtype, with_z):
    """The ``-DLK_LAG_WARP=1`` build of the same source, in which one warp
    sleeps at the start of every stretch between two barriers, gives the
    shipping kernel's ``T``, ``Z``, ``wr``, ``wi``, ``acc``, ``ok`` and
    ``work`` bit for bit: no read depends on which warp gets there first."""
    from lightkrylov_tpu_torch.ops import _build

    A = np.triu(np.random.default_rng(n + 7).standard_normal((n, n)), -1)
    Ht = torch.from_numpy(A).to(cuda, dtype)
    want = kernels.launch_schur(_build.load, Ht, n, with_z, with_z)
    got = kernels.launch_schur(_build.load_lagging, Ht, n, with_z, with_z)
    torch.cuda.synchronize()
    assert bool(want[5]) and _bit_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kdim", [40, 65, 120, 257, 300])
def test_cuda_filter_lagging_warp_build_is_bit_equal(cuda, kdim, dtype):
    """The filter's ``Hf``, ``Z`` and ``work`` from the lagging-warp build,
    bit for bit the shipping kernel's."""
    from lightkrylov_tpu_torch.ops import _build

    Ht = torch.from_numpy(_filter_input(kdim, 3)).to(cuda, dtype)
    wr, wi, order, n, pure, _ = H._filter_shifts(Ht, kdim // 2)
    want = kernels.launch_filter(_build.load, Ht, wr, wi, order, n, pure)
    got = kernels.launch_filter(_build.load_lagging, Ht, wr, wi, order, n, pure)
    torch.cuda.synchronize()
    assert int(want[2][0]) > 0 and _bit_equal(got, want)


@pytest.mark.cuda
def test_cuda_ritz_check_makes_no_host_read(cuda):
    """A check of ``hessenberg_ritz`` at kdim 40 under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    He = np.triu(np.random.default_rng(2).standard_normal((41, 40)), -1)
    Ht = torch.from_numpy(He).to(cuda, torch.float32)
    H.hessenberg_ritz(Ht, 40, 1e-6, 16)
    torch.cuda.synchronize()
    k = torch.full((), 37, device=cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        H.hessenberg_ritz(Ht, k, 1e-6, 16)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_unsupported_tensors(cuda):
    with pytest.raises(TypeError):
        kernels.hessenberg_schur(torch.eye(4, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        kernels.hessenberg_schur(torch.ones(4, 5, device=cuda))
