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
from lightkrylov_tpu_torch.utils import timer

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


def _check_buffer(case):
    """``(H_ext, k_eff, p, nev, tol)`` of a named check: the ``(kdim + p,
    kdim)`` buffers a check sees (a Hessenberg, a block Arnoldi band, the
    Krylov-Schur arrow form after a device Schur restart) at kdim 8-40 with
    ``k_eff <= kdim``, and a triangular one whose eigenvalues hold exact
    duplicates, a pair within ``sep`` (a last bit apart), a real ``+-lambda``
    tie and exact conjugate pairs."""
    kind, kdim, p, k = case
    rng = np.random.default_rng(kdim * 10 + p + k)
    He = np.zeros((kdim + p, kdim))
    if kind == "band":
        He[:k + p, :k] = np.triu(rng.standard_normal((k + p, k)), -p)
    elif kind == "arrow":  # T, the spike row m, then Arnoldi columns
        m = kdim // 2
        He[:m, :m] = np.triu(rng.standard_normal((m, m)))
        He[m, :m] = rng.standard_normal(m)
        for j in range(m, k):
            He[:j + 2, j] = rng.standard_normal(j + 2)
        He[k + 1:, :] = 0.0
        He[:, k:] = 0.0
    else:  # "dups"
        d = rng.standard_normal(k)
        d[3] = d[1]
        d[6] = np.nextafter(d[1], np.inf)
        d[5] = -d[2]
        T = np.triu(rng.standard_normal((k, k)))
        np.fill_diagonal(T, d)
        for i in (8, 11):  # exact conjugate pairs: rotation-scaling blocks
            T[i:i + 2, i:i + 2] = [[d[i], 0.7], [-0.4, d[i]]]
        He[:k, :k] = T
        He[k, k - 1] = 0.8
    return He, k, p, kdim // 2, 0.3


RITZ_CASES = {f"{c[0]}{c[1]}-p{c[2]}-k{c[3]}": c for c in [
    ("band", 8, 1, 8), ("band", 17, 1, 12), ("band", 40, 1, 33), ("band", 20, 2, 15),
    ("band", 24, 3, 24), ("band", 40, 2, 31), ("arrow", 24, 1, 24), ("arrow", 30, 1, 27),
    ("dups", 16, 1, 14), ("dups", 16, 1, 16)]}


@pytest.mark.parametrize("case", sorted(RITZ_CASES))
def test_ritz_check_matches_jax(case, J, jnp):
    """The port's check through the plain banded elimination against the
    JAX check (its realified dense solves): Ritz values within 1e-10 in the
    same order, residuals within ``RTOL64``, the same converged count, zero
    rows from ``k_eff``, and every vector, inactive slots' included, within
    ``RTOL64`` of the JAX one up to a unit complex factor."""
    He, k, p, nev, tol = _check_buffer(RITZ_CASES[case])
    got = H.hessenberg_ritz(torch.from_numpy(He), torch.tensor(k), tol, nev, p=p)
    want = J.hessenberg_ritz(jnp.asarray(He), k, tol, nev, p=p)
    wr, wi, res, Vr, Vi, n_conv, ok = (np.asarray(t) for t in got)
    jwr, jwi, jres, jVr, jVi, jn, jok = (np.asarray(t) for t in want)
    assert bool(ok) and bool(jok)
    assert np.max(np.abs(_w(wr, wi) - _w(jwr, jwi))) < 1e-10
    assert int(n_conv) == int(jn) and 0 < int(jn)
    fin = np.isfinite(jres)
    assert np.array_equal(np.isfinite(res), fin) and fin.sum() == k
    assert np.max(np.abs(res[fin] - jres[fin])) < RTOL64
    V, jV = Vr + 1j * Vi, jVr + 1j * jVi
    assert np.all(V[k:] == 0)
    overlap = np.abs(np.sum(np.conj(jV) * V, axis=0))
    assert np.all(np.abs(overlap - 1.0) < RTOL64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_inverse_iteration_shifts_match_the_jax_formula(dtype, J, jnp):
    """``eps3``, ``sep`` and the shifted real parts equal the JAX
    ``hessenberg_eigvecs``' formula bit for bit, over the embedded matrix
    (whose dummy diagonal makes ``eps3`` about 3x that of the active block
    alone) and over all slots: exact duplicates, a pair a last bit apart,
    and inactive slots at 0 each moved by the earlier slots within ``sep``,
    an active 0 among them."""
    n, k = 12, 8
    A = np.triu(np.random.default_rng(4).standard_normal((n, n)), -1).astype(dtype)
    wr = np.zeros(n, dtype)
    wi = np.zeros(n, dtype)
    wr[:k] = [0.5, 0.5, -0.5, 0.25, np.nextafter(dtype(0.25), dtype(1)), 0.0, 0.1, 0.5]
    wi[6] = 0.3
    Hm, _ = H._embed(torch.from_numpy(A), k)
    eps3, sep, wrp = (t.numpy() for t in H._shifts(Hm, torch.from_numpy(wr),
                                                   torch.from_numpy(wi)))
    Hj, _ = J._embed(jnp.asarray(A), k)
    eps = np.finfo(dtype).eps
    jeps3 = eps * (jnp.max(jnp.abs(Hj)) + 1.0)
    jsep = 4.0 * jeps3
    close = (jnp.abs(wr[None, :] - wr[:, None]) + jnp.abs(wi[None, :] - wi[:, None])) <= jsep
    jwrp = wr + jnp.tril(close, k=-1).sum(axis=1).astype(dtype) * jsep
    assert eps3 == np.asarray(jeps3) and sep == np.asarray(jsep)
    assert np.array_equal(wrp, np.asarray(jwrp))
    assert eps3 > 2.0 * eps * (np.abs(A[:k, :k]).max() + 1.0)
    moved = np.rint((wrp.astype(np.float64) - wr) / sep).astype(int)
    assert moved.tolist() == [0, 1, 0, 0, 1, 0, 0, 2, 1, 2, 3, 4]


@pytest.mark.parametrize("kind", ["arrow", "dense"])
def test_eigvecs_any_structure(kind, rng, J, jnp):
    """``hessenberg_eigvecs`` pivots over each column's possible nonzeros, so
    the Krylov-Schur arrow form (a spike row below a triangle) and a dense
    matrix get their eigenvectors as a Hessenberg does: residuals against
    numpy's eigenvalues, and the JAX vectors up to a unit complex factor."""
    n = 20
    if kind == "dense":
        A = rng.standard_normal((n, n))
    else:
        A = _check_buffer(("arrow", n, 1, n))[0][:n]
    wr, wi, ok = H.hessenberg_eigvals(torch.from_numpy(A))
    Vr, Vi = H.hessenberg_eigvecs(torch.from_numpy(A), wr, wi)
    V, w = Vr.numpy() + 1j * Vi.numpy(), _w(wr, wi)
    assert bool(ok)
    for j in range(n):
        assert np.linalg.norm(A @ V[:, j] - w[j] * V[:, j]) < 1e-10 * np.linalg.norm(A)
    jVr, jVi = J.hessenberg_eigvecs(jnp.asarray(A), jnp.asarray(wr.numpy()),
                                    jnp.asarray(wi.numpy()))
    jV = np.asarray(jVr) + 1j * np.asarray(jVi)
    assert np.all(np.abs(np.abs(np.sum(np.conj(jV) * V, axis=0)) - 1.0) < RTOL64)


def test_f32_vectors_at_a_triple_eigenvalue_are_unit_columns(J, jnp):
    """ROADMAP F11: in f32, at a triple eigenvalue of a triangular check
    (two exact duplicates and one a last bit away) the inverse iteration's
    ``|x|`` reaches ``1 / eps3^3`` and its sum of squares overflows.  The
    JAX check then returns a zero column with a zero residual, counted as
    converged; the port scales ``x`` by a power of two first and returns a
    unit eigenvector, with the JAX check's values (within f32 rounding) and
    every other column."""
    He, k, p, nev, tol = _check_buffer(RITZ_CASES["dups16-p1-k14"])
    He = He.astype(np.float32)
    wr, wi, res, Vr, Vi, n_conv, ok = (np.asarray(t) for t in H.hessenberg_ritz(
        torch.from_numpy(He), k, tol, nev, p=p))
    jwr, jwi, jres, jVr, jVi, jn, jok = (np.asarray(t) for t in J.hessenberg_ritz(
        jnp.asarray(He), k, tol, nev, p=p))
    V, jV = Vr.astype(np.float64) + 1j * Vi, jVr.astype(np.float64) + 1j * jVi
    jnorm = np.linalg.norm(jV, axis=0)
    zero = np.flatnonzero(jnorm == 0)
    assert bool(ok) and bool(jok) and np.max(np.abs(_w(wr, wi) - _w(jwr, jwi))) < 1e-6
    assert len(zero) == 1 and jres[zero[0]] == 0
    assert np.all(np.abs(np.linalg.norm(V, axis=0) - 1.0) < 1e-6)
    A = He.astype(np.float64)[:k, :k]
    j = zero[0]
    w = _w(wr, wi)[j]
    assert np.linalg.norm(A @ V[:k, j] - w * V[:k, j]) < 1e-5 * np.linalg.norm(A)
    rest = np.flatnonzero(jnorm > 0)
    assert np.all(np.abs(np.abs(np.sum(np.conj(jV) * V, axis=0))[rest] - 1.0) < 1e-4)


def _launches(name):
    """The kernel launches counted so far under ``launches.<name>``."""
    return timer.get_counter(f"launches.{name}")


def test_ritz_wrappers_take_the_plain_version_on_the_cpu(rng):
    """On a CPU tensor ``ritz_check`` and ``inverse_iteration`` are their
    plain versions and count no launch."""
    He, k, p, nev, tol = _check_buffer(("band", 12, 1, 10))
    Ht = torch.from_numpy(He)
    _, _, wr, wi, _, ok, _ = kernels.hessenberg_schur(Ht[:12], k)
    before = (_launches("ritz_check"), _launches("inverse_iteration"))
    got = kernels.ritz_check(Ht, wr, wi, ok, k, tol, nev, p)
    want = kernels.ritz_check_reference(Ht, wr, wi, ok, k, tol, nev, p)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = kernels.inverse_iteration(Ht[:12], wr, wi, k)
    want = kernels.inverse_iteration_reference(Ht[:12], wr, wi, k)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (_launches("ritz_check"), _launches("inverse_iteration")) == before


def test_schur_f32_on_a_hessenberg_scaled_to_2_pow_minus_40(J, jnp):
    """ROADMAP Queue 3: the f32 Schur core on a Hessenberg input scaled by
    2^-40.  The port's converges, its eigenvalues within 1e-5 of the
    spectrum's scale (the reduction of a Hessenberg column holds one nonzero
    product, exact; the scaled reflectors (F10) keep the chase's vectors in
    range); the JAX package's runs out of its sweep budget (F10: its
    reflectors are unscaled)."""
    A = (np.triu(np.random.default_rng(3).standard_normal((24, 24)), -1)
         * 2.0 ** -40).astype(np.float32)
    w_ref = np.linalg.eigvals(A.astype(np.float64))
    wr, wi, ok = H.hessenberg_eigvals(torch.from_numpy(A))
    _, _, jok = J.hessenberg_eigvals(jnp.asarray(A))
    assert bool(ok) and _match(_w(wr, wi), w_ref) < 1e-5 * np.abs(w_ref).max()
    assert not bool(jok)


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


# float64 / float32: eigenvalues of the spectrum's scale (the JAX package's
# LAPACK gates, as above), factorization and orthogonality (2-norms)
ORD_EIG = {np.float64: 1e-11, np.float32: 1e-4}
ORD_FACT = {np.float64: 1e-12, np.float32: 1e-5}


def _zero_pattern_ok(T):
    """``T`` quasi-triangular: exact zeros below the subdiagonal, and each
    nonzero subdiagonal entry the coupling of a 2x2 conjugate-pair block
    (no two in a row)."""
    sub = np.diag(T, -1) != 0
    pairs_ok = all(((T[i, i] - T[i + 1, i + 1]) / 2) ** 2 + T[i, i + 1] * T[i + 1, i] < 0
                   for i in np.flatnonzero(sub))
    return bool(np.all(np.tril(T, -2) == 0) and not np.any(sub[1:] & sub[:-1]) and pairs_ok)


def _hold_ordschur_to_jax(T, Z, mask, J, jnp, want_ok=True):
    """The port's plain reorder (``ops.hessenberg.ordschur`` on a CPU tensor)
    and the JAX package's ``ordschur_device`` on the same ``(T, Z, mask)``:
    the same ``sel'`` and ``ok``, the leading block's spectrum within
    ``ORD_EIG`` of the spectrum's scale, ``Z'^T Z' = I``, ``Z' T' Z'^T = Z T
    Z^T`` within ``ORD_FACT`` and the zero pattern below the block diagonal.
    Returns the port's ``(T', Z', sel', swaps)``."""
    dt = T.dtype.type
    before = _launches("ordschur")
    T2, Z2, sel2, ok2, swaps = kernels.ordschur(torch.from_numpy(T), torch.from_numpy(Z),
                                                torch.from_numpy(mask))
    assert _launches("ordschur") == before
    jT2, _, jsel2, jok2 = J.ordschur_device(jnp.asarray(T), jnp.asarray(Z), jnp.asarray(mask))
    T2, Z2, sel2 = T2.numpy(), Z2.numpy(), sel2.numpy()
    assert np.array_equal(sel2, np.asarray(jsel2)) and bool(ok2) == bool(jok2) == want_ok
    ns = int(np.argmin(np.append(sel2, False)))  # the leading run of selected positions
    scale = max(1.0, float(np.abs(np.linalg.eigvals(T.astype(np.float64))).max()))
    if ns:
        lead = np.linalg.eigvals(T2[:ns, :ns].astype(np.float64))
        jlead = np.linalg.eigvals(np.asarray(jT2, np.float64)[:ns, :ns])
        assert _match(lead, jlead) < ORD_EIG[dt] * scale
    A = Z.astype(np.float64) @ T.astype(np.float64) @ Z.T.astype(np.float64)
    T2d, Z2d = T2.astype(np.float64), Z2.astype(np.float64)
    assert np.linalg.norm(Z2d @ T2d @ Z2d.T - A, 2) < ORD_FACT[dt] * np.linalg.norm(A, 2)
    assert np.linalg.norm(Z2d.T @ Z2d - np.eye(len(Z2d)), 2) < ORD_FACT[dt]
    assert _zero_pattern_ok(T2)
    return T2, Z2, sel2, int(swaps)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [6, 13, 24, 40])
def test_ordschur_plain_matches_jax(n, dtype, J, jnp):
    """The plain reorder against the JAX package's on the Schur form of a
    seeded random matrix and three seeded masks each: the selected
    eigenvalues lead, ``sel'`` all True then all False."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n)).astype(dtype)
    T, Z, _, _, _ = H.schur_real(torch.from_numpy(A))
    T, Z = T.numpy(), Z.numpy()
    for _ in range(3):
        mask = rng.random(n) < 0.4
        _, _, sel2, swaps = _hold_ordschur_to_jax(T, Z, mask, J, jnp)
        ns = int(sel2.sum())
        assert np.all(sel2[:ns]) and not np.any(sel2[ns:]) and swaps >= 0


def _two_blocks(n1, n2, dtype):
    """A quasi-triangular ``T`` (order 7) whose blocks at 2 (size ``n1``) and
    below it (size ``n2``) have distinct spectra, 2x2 blocks conjugate
    pairs, a seeded orthogonal ``Z``, and the mask that selects the lower
    block and positions 0 and 1: one swap, of sizes ``(n1, n2)``."""
    rng = np.random.default_rng(10 * n1 + n2)
    n = 2 + n1 + n2 + 1
    T = np.triu(rng.standard_normal((n, n)))
    np.fill_diagonal(T, [3.0, -2.5, 0.0, 0.0, 0.0, 0.0, 1.7][:n])
    i, j = 2, 2 + n1
    if n1 == 2:
        T[i:i + 2, i:i + 2] = [[0.4, 1.3], [-0.6, 0.4]]
    else:
        T[i, i] = 0.4
    if n2 == 2:
        T[j:j + 2, j:j + 2] = [[-1.1, 0.5], [-2.0, -1.1]]
    else:
        T[j, j] = -1.1
    T[-1, -1] = 1.7
    Z, _ = np.linalg.qr(rng.standard_normal((n, n)))
    mask = np.zeros(n, bool)
    mask[:2] = True
    mask[j] = True
    return T.astype(dtype), Z.astype(dtype), mask


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n1, n2", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_ordschur_plain_block_pairs_match_jax(n1, n2, dtype, J, jnp):
    """Each pair of block sizes ``(n1, n2)`` of Bai and Demmel's swap (a 1x1
    to 4x4 Sylvester system), with the flag on one position of a 2x2 block
    only (made pair-consistent), and the exact zeros below the new block
    diagonal."""
    T, Z, mask = _two_blocks(n1, n2, dtype)
    T2, _, sel2, swaps = _hold_ordschur_to_jax(T, Z, mask, J, jnp)
    assert swaps == 1 and int(sel2.sum()) == 2 + n2
    w2 = np.sort_complex(np.linalg.eigvals(T2[2:2 + n2, 2:2 + n2].astype(np.float64)))
    w = np.sort_complex(np.linalg.eigvals(T[2 + n1:2 + n1 + n2, 2 + n1:2 + n1 + n2]
                                          .astype(np.float64)))
    assert np.abs(w2 - w).max() < ORD_EIG[dtype] * 4


# A 2x2 to 2x2 swap that both packages reject: close spectra (the Sylvester
# system near singular) and strongly anisotropic blocks, found by a seeded
# search; the annihilated coupling reads 5.9e3 (float64) and 1.6e3 (float32)
# times the threshold in the plain version
REJECTED_SWAP = {
    np.float64: ([[127.1385425787297, 200.29823611192407],
                  [-78.97094112945011, -124.39864652307723]],
                 [[-0.01171733098748834, 0.01489933173909488],
                  [0.002631622297373081, 0.0005356923366558498]],
                 [[5.82393587057546, 16.632433892017662],
                  [-1.1915789103631635, -3.079551599046841]]),
    np.float32: ([[20.626829244989427, 89.2752981434197],
                  [-5.182090745772779, -22.390958831924095]],
                 [[2.402463582574814, 2.8680934833900404],
                  [3.209092213287196, -1.6650554285939745]],
                 [[-15.990148385446398, 13.813891555321634],
                  [-16.514161905132976, 14.217444684757032]]),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ordschur_plain_rejects_the_swap_jax_rejects(dtype, J, jnp):
    """A swap both packages reject: the first swap (a selected 1x1 past an
    unselected one) is applied, then the 2x2 to 2x2 swap is rejected, so
    both stop with ``ok`` False and the same partial reorder."""
    A11, A12, A22 = (np.array(b) for b in REJECTED_SWAP[dtype])
    n = 6
    T = np.triu(np.random.default_rng(6).standard_normal((n, n)) * 0.1)
    T[0, 0], T[1, 1] = 0.3, 5.0
    T[2:4, 2:4], T[2:4, 4:6], T[4:6, 4:6] = A11, A12, A22
    Z, _ = np.linalg.qr(np.random.default_rng(7).standard_normal((n, n)))
    mask = np.array([False, True, False, False, True, True])
    T2, _, sel2, swaps = _hold_ordschur_to_jax(T.astype(dtype), Z.astype(dtype), mask, J, jnp,
                                               want_ok=False)
    assert swaps == 1 and sel2.tolist() == [True, False, False, False, True, True]
    assert T2[0, 0] == pytest.approx(5.0, rel=1e-5)
    _, resid, bad = H._swap_plain(T2[2:6, 2:6], 2, 2, np.abs(T2).max())
    assert bad and resid > 30 * dtype(50) * np.finfo(dtype).eps * (np.abs(T2).max() + 1)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ordschur_plain_with_inactive_identity_positions(dtype, J, jnp):
    """A block restart's reorder (``p > 1``): the Schur form of the active
    ``k_eff`` block embedded with its dummy diagonal, and a mask with the
    inactive positions deselected, as ``krylov_schur_device`` passes it."""
    n, k = 24, 19
    rng = np.random.default_rng(24)
    A = np.triu(rng.standard_normal((n, n)), -2).astype(dtype)
    T, Z, _, _, _ = H.schur_real(torch.from_numpy(A), k_eff=k)
    mask = (rng.random(n) < 0.5) & (np.arange(n) < k)
    _, _, sel2, _ = _hold_ordschur_to_jax(T.numpy(), Z.numpy(), mask, J, jnp)
    assert int(sel2.sum()) >= int(mask.sum()) and not np.any(sel2[int(sel2.sum()):])


@pytest.mark.parametrize("q", [1, 2, 4])
def test_ordschur_elimination_matches_numpy_solve(q):
    """The swap's explicit Gaussian elimination with partial pivoting
    (``_solve_pivoted``, which ``csrc/ordschur.cu`` repeats) against
    ``numpy.linalg.solve`` on the Sylvester system ``K`` of seeded windows,
    and on a ``K`` whose first column needs a row exchange."""
    n1, n2 = {1: (1, 1), 2: (2, 1), 4: (2, 2)}[q]
    rng = np.random.default_rng(q)
    for _ in range(5):
        W = np.triu(rng.standard_normal((n1 + n2, n1 + n2)), -1)
        K, rhs = H._sylvester_system(W, n1, n2)
        assert K.shape == (q, q)
        x = H._solve_pivoted(K, rhs)
        assert np.linalg.norm(x - np.linalg.solve(K, rhs)) < 1e-13 * np.linalg.norm(x)
    K = rng.standard_normal((q, q))
    K[0, 0] = 0.0
    b = rng.standard_normal(q)
    if q > 1:
        x = H._solve_pivoted(K, b)
        assert np.linalg.norm(x - np.linalg.solve(K, b)) < 1e-13 * np.linalg.norm(x)


def test_ordschur_wrapper_takes_the_plain_version_on_the_cpu(rng):
    """On a CPU tensor ``ops.hessenberg.ordschur`` is its plain version,
    counts no launch, and ``utils.hessenberg.ordschur_device`` returns its
    first four outputs."""
    A = torch.from_numpy(rng.standard_normal((12, 12)))
    T, Z, _, _, _ = H.schur_real(A)
    mask = torch.from_numpy(rng.random(12) < 0.5)
    before = _launches("ordschur")
    got = kernels.ordschur(T, Z, mask)
    want = kernels.ordschur_reference(T, Z, mask)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(H.ordschur_device(T, Z, mask), got[:4]))
    assert _launches("ordschur") == before and got[4].dtype == torch.int32


@pytest.mark.parametrize("n, nz, itemsize, t_smem, z_smem", [
    (119, 119, 8, True, True), (120, 120, 8, True, False),
    (169, 169, 8, True, False), (170, 170, 8, False, False),
    (169, 169, 4, True, True), (170, 170, 4, True, False),
    (240, 240, 4, True, False), (241, 241, 4, False, False),
    (40, 300, 8, True, True), (100, 300, 8, True, False)])
def test_ordschur_geometry_places_t_and_z_by_the_shared_memory_limit(n, nz, itemsize, t_smem,
                                                                      z_smem):
    """The ordschur kernel keeps ``T`` in shared memory while it fits and
    ``Z`` (``nz`` rows) while both do, each row of odd stride ``n | 1``,
    beside the mask (``n`` bytes)."""
    geo = kernels.ordschur_geometry(n, nz, itemsize)
    assert (geo.h_smem, geo.z_smem) == (t_smem, z_smem)
    assert geo.smem_bytes <= _BUDGET and geo.warps == min(8, -(-n // 32))
    assert geo.smem_bytes == (n | 1) * itemsize * (n * t_smem + nz * z_smem) + n


# -- the range prescale of the Schur core (ROADMAP F12) --------------------------

@pytest.mark.parametrize("dtype, e", [(np.float32, -42), (np.float32, -45), (np.float32, -60),
                                      (np.float32, -100), (np.float32, 60),
                                      (np.float64, -520), (np.float64, 520)])
def test_schur_prescales_a_block_out_of_range(dtype, e):
    """A random Hessenberg scaled by ``2^e`` outside ``[sqrt(tiny) / eps,
    eps / sqrt(tiny)]``: the Schur core scales its block into ``[0.5, 1)``
    first (an exact power of two, as LAPACK ``xGEEV``), so the eigenvalues
    come within 1e-5 (float32) / 1e-11 (float64) of the spectrum's scale
    and ``T``, unscaled, keeps ``H = Z T Z^T``.  Unscaled, the reduction's
    products ``u (u^T H)``, cubic in the scale, leave the range (float32:
    1.9e-4 at 2^-42, non-finite at 2^-60 and 2^60).  The JAX package's f32
    core fails from 2^-25 (F10)."""
    A = (np.triu(np.random.default_rng(3).standard_normal((24, 24)), -1) * 2.0 ** e).astype(dtype)
    s = 2.0 ** -e  # held at 2^0, an exact scale: numpy's eig need not hold at 2^-520
    Ad = A.astype(np.float64) * s
    w_ref = np.linalg.eigvals(Ad)
    tol = 1e-5 if dtype == np.float32 else 1e-11
    wr, wi, ok = H.hessenberg_eigvals(torch.from_numpy(A))
    assert bool(ok) and _match(_w(wr, wi) * s, w_ref) < tol * np.abs(w_ref).max()
    T, Z, wr, wi, ok = H.schur_real(torch.from_numpy(A))
    T, Z = T.double().numpy() * s, Z.double().numpy()
    assert bool(ok) and _match(_w(wr, wi) * s, w_ref) < tol * np.abs(w_ref).max()
    assert np.linalg.norm(Z @ T @ Z.T - Ad, 2) < tol * np.linalg.norm(Ad, 2)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_schur_prescale_changes_no_bit_in_range(dtype, monkeypatch):
    """At 2^0 (inside the range) the Schur core's outputs are bit-identical
    with the prescale's code and without it."""
    A = torch.from_numpy(np.triu(np.random.default_rng(3).standard_normal((24, 24)), -1)
                         .astype(dtype))
    got = H._schur_plain(A, 24, True, True)
    monkeypatch.setattr(H, "_range_exponent", lambda *args: 0)
    want = H._schur_plain(A, 24, True, True)
    assert _bit_equal(got, want)


def test_ritz_check_prescales_a_buffer_out_of_range():
    """The device check in float32 on an Arnoldi buffer scaled by 2^-60: the
    inverse iteration prescales the block and the eigenvalues as the Schur
    core does, so its ridge ``eps (max |Hm| + 1)`` stays relative to the
    block and the check reads as at 2^0 (the same converged count, values
    and vectors of the same quality).  Unscaled, the ridge (1.2e-7) swamps
    a block of 2^-60 (eigen-residuals 0.44 of ||H||)."""
    He = _arnoldi_hessenberg(24, 1, ext=True).astype(np.float32)
    out = {}
    for e in (0, -60):
        Ht = torch.from_numpy(He * np.float32(2.0 ** e))
        wr, wi, res, Vr, Vi, n_conv, ok = H.hessenberg_ritz(Ht, 24, 1e-6 * 2.0 ** e, 16)
        V = Vr.double().numpy() + 1j * Vi.double().numpy()
        w = _w(wr, wi) * 2.0 ** -e
        Ha = He[:24].astype(np.float64)
        er = max(np.linalg.norm(Ha @ V[:, j] - w[j] * V[:, j]) for j in range(24))
        out[e] = (bool(ok), int(n_conv), w, er / np.linalg.norm(Ha))
    assert out[0][:2] == out[-60][:2] == (True, 4)
    assert np.abs(out[0][2] - out[-60][2]).max() < 1e-5 * np.abs(out[0][2]).max()
    assert out[-60][3] < 1e-5


def test_filter_f32_at_2_pow_minus_60_needs_no_prescale():
    """The IRAM filter in float32 on an Arnoldi Hessenberg scaled by 2^-60
    keeps the leading spectrum as at 2^0.  It did so before it had a
    prescale of its own (its sweeps' vectors are scaled already, F10; its
    shifts come from the prescaled Schur core); the range fault showed
    further out (test_filter_prescales_a_hessenberg_out_of_range)."""
    Hs = _filter_input(24, 1)
    w = np.linalg.eigvals(Hs)
    for e in (0, -60):
        Ht = torch.from_numpy((Hs * 2.0 ** e).astype(np.float32))
        Hf, Z, n, ok = H.francis_filter(Ht, 12)
        n = int(n)
        kept = np.linalg.eigvals(Hf.double().numpy()[:n, :n]) * 2.0 ** -e
        assert bool(ok) and _match(kept, w[np.argsort(-np.abs(w))][:n]) < \
            FILTER_TOL[torch.float32] * np.linalg.norm(Hs)


@pytest.mark.parametrize("e", [-100, 60])
def test_filter_prescales_a_hessenberg_out_of_range(e):
    """The IRAM filter in float32 on an Arnoldi Hessenberg scaled by 2^-100
    and 2^60 (outside [2^-40, 2^40]): its sweeps scale ``H`` and the shifts
    into the range first, as the Schur core does (ROADMAP F14), so it keeps
    the keep count, the sweeps and the kept spectrum of the 2^0 run, scaled,
    and ``Z`` is that run's.  Unscaled, the sweeps' first vector, quadratic
    in the scale, left the kept spectrum 0.18 of ||H|| off at 2^-100 and
    non-finite at 2^60."""
    Hs = _filter_input(24, 1)
    H0 = torch.from_numpy(Hs.astype(np.float32))
    Hf0, Z0, n0, ok0 = H.francis_filter(H0, 12)
    Hf, Z, n, ok = H.francis_filter(torch.from_numpy((Hs * 2.0 ** e).astype(np.float32)), 12)
    n = int(n)
    assert bool(ok) and bool(ok0) and n == int(n0)
    kept = np.linalg.eigvals(Hf.double().numpy()[:n, :n]) * 2.0 ** -e
    kept0 = np.linalg.eigvals(Hf0.double().numpy()[:n, :n])
    assert _match(kept, kept0) < FILTER_TOL[torch.float32] * np.linalg.norm(Hs)
    assert bool(torch.isfinite(Hf).all())
    assert np.abs(Z.numpy() - Z0.numpy()).max() < 1e-5


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_filter_prescale_changes_no_bit_in_range(dtype, monkeypatch):
    """At 2^0 (inside the range) the filter's sweeps give bit-identical
    outputs with the prescale's code and without it."""
    A = torch.from_numpy(_filter_input(24, 1).astype(dtype))
    wr, wi, order, n, pure, _ = H._filter_shifts(A, 12)
    got = kernels.francis_filter_sweeps_reference(A, wr, wi, order, n, pure)
    monkeypatch.setattr(H, "_range_exponent", lambda *args: 0)
    want = kernels.francis_filter_sweeps_reference(A, wr, wi, order, n, pure)
    assert _bit_equal(got, want) and int(got[2][0]) > 0


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
    before = (_launches("hessenberg_schur"), _launches("francis_filter_sweeps"))
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
    assert before == (_launches("hessenberg_schur"), _launches("francis_filter_sweeps"))


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


@pytest.mark.parametrize("n, itemsize, w_smem", [
    (40, 4, True), (40, 8, True), (118, 8, True), (119, 8, False), (167, 4, True),
    (168, 4, False), (300, 4, False), (300, 8, False)])
def test_ritz_geometry_places_w_by_the_shared_memory_limit(n, itemsize, w_smem):
    """The Ritz kernel's working matrices (n rows of odd stride, real and
    imaginary parts, one a slot) stay in shared memory to n = 167 in f32 and
    118 in f64, and a launch never asks for more than a CTA may take."""
    g = kernels.ritz_geometry(n, itemsize)
    assert g.w_smem == w_smem
    w = 2 * n * ((n + 1) | 1) * itemsize
    h = n * (n | 1) * itemsize
    need = h * g.h_smem + 4 * n * itemsize + 16 * n + g.slots * (w * w_smem + 4 * n)
    assert g.smem_bytes == need <= _BUDGET


# (n, itemsize) -> (slots, h_smem, w_smem, cols) at each edge of the Ritz
# kernel's geometry: the slots a CTA, the staged block and the working
# matrices leaving shared memory, the columns a lane of the register path
RITZ_GEOMETRY_ROWS = {
    (32, 4): (4, True, True, 1), (33, 4): (4, True, True, 2), (64, 4): (4, True, True, 2),
    (65, 4): (4, True, True, 4), (78, 4): (4, True, True, 4), (79, 4): (3, True, True, 4),
    (89, 4): (3, True, True, 4), (90, 4): (2, True, True, 4), (106, 4): (2, True, True, 4),
    (107, 4): (1, True, True, 4), (128, 4): (1, True, True, 4), (129, 4): (1, True, True, 10),
    (136, 4): (1, True, True, 10), (137, 4): (1, False, True, 10),
    (167, 4): (1, False, True, 10), (168, 4): (4, True, False, 10),
    (234, 4): (4, True, False, 10), (235, 4): (3, True, False, 10),
    (236, 4): (4, False, False, 10), (320, 4): (4, False, False, 10),
    (321, 4): (4, False, False, 0),
    (32, 8): (4, True, True, 1), (33, 8): (4, True, True, 2), (55, 8): (4, True, True, 2),
    (56, 8): (3, True, True, 2), (62, 8): (3, True, True, 2), (63, 8): (2, True, True, 2),
    (65, 8): (2, True, True, 4), (74, 8): (2, True, True, 4), (75, 8): (1, True, True, 4),
    (96, 8): (1, True, True, 4), (97, 8): (1, False, True, 4), (118, 8): (1, False, True, 4),
    (119, 8): (4, True, False, 4), (129, 8): (4, True, False, 10),
    (165, 8): (4, True, False, 10), (166, 8): (3, True, False, 10),
    (167, 8): (1, True, False, 10), (168, 8): (4, False, False, 10),
    (321, 8): (4, False, False, 0)}


@pytest.mark.parametrize("n, itemsize", sorted(RITZ_GEOMETRY_ROWS))
def test_ritz_geometry_rows(n, itemsize):
    """The Ritz kernel's layout at each edge: block and working matrices in
    shared memory while both fit (with as many slots as fit, at most 4),
    then the working matrices alone, then the staged block alone, then
    neither; 1, 2, 4 or 10 columns a lane on the register path, none beyond
    kdim 320."""
    g = kernels.ritz_geometry(n, itemsize)
    assert (g.slots, g.h_smem, g.w_smem, g.cols) == RITZ_GEOMETRY_ROWS[n, itemsize]
    assert g.slots <= kernels.RITZ_MAX_SLOTS and g.smem_bytes <= _BUDGET
    assert g.cols == 0 or 32 * g.cols >= n


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
    before = _launches("hessenberg_schur")
    T, Z, wr, wi, acc, ok, work = kernels.hessenberg_schur(Ht, k, with_z=with_z, split=with_z)
    torch.cuda.synchronize()
    assert _launches("hessenberg_schur") == before + 1
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


def _arnoldi_hessenberg(kdim, seed, n=256, real=None, ext=False):
    """The square Arnoldi Hessenberg of a matrix of order ``n`` with a known,
    well-separated complex spectrum (chip_smoke.py's input for the filter),
    with ``real`` one more, real eigenvalue: the exact-shift filter is
    forward-unstable on a random non-normal Hessenberg, so kernel and plain
    version agree there only up to that instability.  With ``ext`` the
    ``(kdim + 1, kdim)`` buffer of a check."""
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
    return H if ext else H[:kdim, :kdim]


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
    before = _launches("francis_filter_sweeps")
    Hf, Z, work = kernels.francis_filter_sweeps(Ht, wr, wi, order, n, pure)
    torch.cuda.synchronize()
    assert _launches("francis_filter_sweeps") == before + 1
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
    ``torch.cuda.set_sync_debug_mode("error")``, with ``k_eff`` an int and a
    0-d tensor on the card, for ``p = 1`` and a block buffer with ``p = 2``."""
    for p in (1, 2):
        He = np.triu(np.random.default_rng(2).standard_normal((40 + p, 40)), -p)
        Ht = torch.from_numpy(He).to(cuda, torch.float32)
        H.hessenberg_ritz(Ht, 40, 1e-6, 16, p=p)
        torch.cuda.synchronize()
        k = torch.full((), 37, device=cuda)
        torch.cuda.set_sync_debug_mode("error")
        try:
            H.hessenberg_ritz(Ht, k, 1e-6, 16, p=p)
            H.hessenberg_ritz(Ht, 38, 1e-6, 16, p=p)
        finally:
            torch.cuda.set_sync_debug_mode(0)


# ||Hm v - lambda v|| / ||H||_F of an inverse-iteration vector, in f64; in
# f32 the method's own residual grows with kdim (the JAX package's f32
# vectors read 1.3e-5 to 3.5e-5 on the Arnoldi inputs at kdim 16-128, the
# plain version's 5.4e-5 at 169), so there the kernel is held to the plain
# version's residual within KERNEL_TOL alone
RITZ_RESID_TOL = {torch.float32: float("inf"), torch.float64: 1e-11}


def _hold_ritz_to_plain(cuda, dtype, He, k, p, nev, tol):
    """One launch of the Ritz kernel on the Schur kernel's eigenvalues of
    ``He`` against its plain version on the same inputs: the same values in
    the same order, count, infinite residuals and zero rows from ``k_eff``;
    each active column's eigen-residual ``||Hm v - lambda v||`` within
    ``KERNEL_TOL`` of the plain version's (and within ``RITZ_RESID_TOL``), each
    column's overlap ``|v^H v_plain|`` and norm, and the finite residuals
    (against ``|beta|`` or ``||B||``) within ``KERNEL_TOL``."""
    kdim = He.shape[1]
    Ht = torch.from_numpy(He).to(cuda, dtype)
    _, _, wr, wi, _, ok, _ = kernels.hessenberg_schur(Ht[:kdim].contiguous(), k)
    before = _launches("ritz_check")
    got = kernels.ritz_check(Ht, wr, wi, ok, k, tol, nev, p)
    torch.cuda.synchronize()
    assert _launches("ritz_check") == before + 1
    want = kernels.ritz_check_reference(Ht, wr, wi, ok, k, tol, nev, p)
    (gwr, gwi, gres, gVr, gVi, gn), (pwr, pwi, pres, pVr, pVi, pn) = (
        [t.cpu() for t in out] for out in (got, want))
    assert bool(ok)
    assert torch.equal(gwr, pwr) and torch.equal(gwi, pwi) and int(gn) == int(pn)
    fin = torch.isfinite(pres)
    assert torch.equal(torch.isfinite(gres), fin) and int(fin.sum()) == k
    assert torch.all(gVr[k:] == 0) and torch.all(gVi[k:] == 0)
    tol_k = KERNEL_TOL[dtype]
    A = Ht.double().cpu().numpy()
    Ha = A[:k, :k]
    V = gVr.double().numpy() + 1j * gVi.double().numpy()
    Vp = pVr.double().numpy() + 1j * pVi.double().numpy()
    w = _w(gwr, gwi)
    for j in np.flatnonzero(fin.numpy()):
        r, rp = (np.linalg.norm(Ha @ X[:k, j] - w[j] * X[:k, j]) / np.linalg.norm(Ha)
                 for X in (V, Vp))
        assert r < RITZ_RESID_TOL[dtype] and abs(r - rp) < tol_k
    assert np.all(np.abs(np.abs(np.sum(np.conj(Vp) * V, axis=0)) - 1.0) < tol_k)
    assert np.all(np.abs(np.linalg.norm(V, axis=0) - 1.0) < tol_k)
    if p == 1:
        scale = abs(A[k, k - 1])
    else:
        scale = np.linalg.norm(A[k:k + p, max(k - p, 0):max(k - p, 0) + p], 2)
    d = np.abs(gres.double().numpy()[fin.numpy()] - pres.double().numpy()[fin.numpy()])
    assert np.all(d <= tol_k * max(scale, 1e-300))


# kdim: the phase's sizes and each edge of ritz_geometry() (RITZ_GEOMETRY_ROWS):
# the columns a lane (33, 65, 129, 321), the slots a CTA (f32 79, 90, 107;
# f64 56, 63, 75), the staged block and the working matrices leaving shared
# memory (f32 137, 168, 236; f64 97, 119, 168)
RITZ_NS = [16, 30, 32, 33, 40, 55, 56, 62, 63, 64, 65, 74, 75, 78, 79, 89, 90, 96, 97, 106,
           107, 118, 119, 120, 128, 129, 136, 137, 167, 168, 169, 170, 235, 236, 240, 257, 300,
           321]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kdim", RITZ_NS)
def test_cuda_ritz_kernel_matches_plain(cuda, dtype, kdim):
    He = _arnoldi_hessenberg(kdim, kdim, 256 if kdim <= 128 else 512, ext=True)
    _hold_ritz_to_plain(cuda, dtype, He, kdim, 1, 16, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(RITZ_CASES) + ["keff100of128", "band64-p4-k60",
                                                       "band170-p2-k165"])
def test_cuda_ritz_kernel_special_cases(cuda, dtype, case):
    """``k_eff < kdim``, ``p = 2, 3, 4``, the arrow form, exact and
    near duplicates, a ``+-lambda`` tie and exact conjugate pairs."""
    if case == "keff100of128":
        He, k, p, nev, tol = _arnoldi_hessenberg(128, 7, ext=True), 100, 1, 16, 1e-6
        He[101:, :] = 0.0
        He[:, 100:] = 0.0
    elif case.startswith("band64") or case.startswith("band170"):
        kdim, p, k = (64, 4, 60) if case.startswith("band64") else (170, 2, 165)
        He, k, p, nev, tol = _check_buffer(("band", kdim, p, k))
    else:
        He, k, p, nev, tol = _check_buffer(RITZ_CASES[case])
    _hold_ritz_to_plain(cuda, dtype, He, k, p, nev, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("kdim", [16, 64, 97, 128, 168, 240, 300])
def test_cuda_ritz_kernel_general_path(cuda, dtype, kdim, p):
    """Block Arnoldi bands (p + 1 candidate rows a step) take the general
    path, at each layout of ritz_geometry(): the same gates as the register
    path's Hessenberg and arrow inputs."""
    He, k, p, nev, tol = _check_buffer(("band", kdim, p, kdim - p))
    _hold_ritz_to_plain(cuda, dtype, He, k, p, nev, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [40, 97, 168, 257])
def test_cuda_ritz_lagging_warp_build_is_bit_equal(cuda, n, dtype):
    """The Ritz kernel's outputs from the lagging-warp build (a warp sleeps
    at the start of each stretch of the CTA's staging), bit for bit the
    shipping kernel's, on an Arnoldi buffer (the register path) and a band
    (the general path)."""
    from lightkrylov_tpu_torch.ops import _build

    for He, k, p in ((_arnoldi_hessenberg(n, n, 256 if n <= 128 else 512, ext=True), n, 1),
                     _check_buffer(("band", n, 2, n - 2))[:3]):
        Ht = torch.from_numpy(He).to(cuda, dtype)
        _, _, wr, wi, _, ok, _ = kernels.hessenberg_schur(Ht[:n].contiguous(), k)
        want = kernels.launch_ritz(_build.load, Ht, wr, wi, k, ok, 1e-6, 16, p)
        got = kernels.launch_ritz(_build.load_lagging, Ht, wr, wi, k, ok, 1e-6, 16, p)
        torch.cuda.synchronize()
        assert _bit_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind, n", [("dense", 40), ("dense", 120), ("arrow", 64), ("arrow", 200)])
def test_cuda_inverse_iteration_matches_plain(cuda, dtype, kind, n):
    """``inverse_iteration`` (the kernel's vectors alone, slot order) on a
    dense matrix and the arrow form against its plain version, up to a unit
    complex factor."""
    if kind == "dense":
        A = np.random.default_rng(n).standard_normal((n, n))
    else:
        A = _check_buffer(("arrow", n, 1, n))[0][:n]
    Ht = torch.from_numpy(A).to(cuda, dtype)
    wr, wi, ok = H.hessenberg_eigvals(Ht)
    before = _launches("inverse_iteration")
    Vr, Vi = kernels.inverse_iteration(Ht, wr, wi, n - 3)
    torch.cuda.synchronize()
    assert _launches("inverse_iteration") == before + 1
    pVr, pVi = kernels.inverse_iteration_reference(Ht, wr, wi, n - 3)
    V = Vr.double().cpu().numpy() + 1j * Vi.double().cpu().numpy()
    Vp = pVr.double().cpu().numpy() + 1j * pVi.double().cpu().numpy()
    assert bool(ok) and np.all(V[n - 3:] == 0)
    assert np.all(np.abs(np.abs(np.sum(np.conj(Vp) * V, axis=0)) - 1.0) < KERNEL_TOL[dtype])


@pytest.mark.cuda
def test_cuda_wrappers_refuse_unsupported_tensors(cuda):
    with pytest.raises(TypeError):
        kernels.hessenberg_schur(torch.eye(4, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        kernels.hessenberg_schur(torch.ones(4, 5, device=cuda))
    w = torch.zeros(4, device=cuda)
    with pytest.raises(ValueError):
        kernels.ritz_check(torch.ones(4, 4, device=cuda), w, w, True, 4, 1e-6)
    with pytest.raises(TypeError):
        kernels.inverse_iteration(torch.eye(4, device=cuda, dtype=torch.float16), w, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, e", [(torch.float32, -60), (torch.float32, 60),
                                      (torch.float64, -520)])
def test_cuda_schur_kernel_prescale(cuda, dtype, e):
    """The Schur kernel on a Hessenberg outside the range: it prescales the
    block as the plain version does (``range_exp``), takes its sweeps and
    chase steps, and unscales ``T`` and the eigenvalues."""
    Ht = torch.from_numpy(np.triu(np.random.default_rng(3).standard_normal((24, 24)), -1)
                          * 2.0 ** e).to(cuda, dtype)
    T, Z, wr, wi, _, ok, work = kernels.hessenberg_schur(Ht, 24, with_z=True, split=True)
    torch.cuda.synchronize()
    _, _, pwr, pwi, _, pok, pwork = kernels.hessenberg_schur_reference(Ht, 24, True, True)
    assert bool(ok) and bool(pok) and work.tolist() == pwork.tolist()
    # held at 2^0 (an exact scale): numpy's eig need not hold at 2^-520
    s = 2.0 ** -e
    Ad = Ht.double().cpu().numpy() * s
    norm = np.linalg.norm(Ad)
    w = _w(wr.cpu(), wi.cpu()) * s
    assert _match(w, _w(pwr.cpu(), pwi.cpu()) * s) < KERNEL_TOL[dtype] * norm
    assert _match(w, np.linalg.eigvals(Ad)) < KERNEL_TOL[dtype] * norm
    T, Z = T.double().cpu().numpy() * s, Z.double().cpu().numpy()
    assert np.linalg.norm(Z @ T @ Z.T - Ad, 2) < SCHUR_ORTH[dtype] * np.linalg.norm(Ad, 2)
    assert np.linalg.norm(Z.T @ Z - np.eye(24), 2) < SCHUR_ORTH[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, e", [(torch.float32, -100), (torch.float32, 60),
                                      (torch.float64, -520), (torch.float64, 520)])
def test_cuda_filter_kernel_prescale(cuda, dtype, e):
    """The filter kernel on an Arnoldi Hessenberg outside the range: it
    prescales ``H`` and the shifts as the plain version does, takes its
    sweeps and chase steps, and unscales ``Hf``; ``Z`` is the 2^0 run's."""
    A = _filter_input(40, 1)
    H0 = torch.from_numpy(A).to(cuda, dtype)
    Ht = torch.from_numpy(A * 2.0 ** e).to(cuda, dtype)
    wr, wi, order, n, pure, ok = H._filter_shifts(Ht, 20)
    Hf, Z, work = kernels.francis_filter_sweeps(Ht, wr, wi, order, n, pure)
    torch.cuda.synchronize()
    Hp, Zp, pwork = kernels.francis_filter_sweeps_reference(Ht, wr, wi, order, n, pure)
    _, Z0, work0 = kernels.francis_filter_sweeps(H0, *H._filter_shifts(H0, 20)[:5])
    n, s = int(n), 2.0 ** -e
    assert bool(ok & pure) and work.tolist() == pwork.tolist() == work0.tolist()
    assert bool(torch.isfinite(Hf).all())
    # held at 2^0 (an exact scale): numpy's eig need not hold at 2^-520
    kept = np.linalg.eigvals(Hf.double().cpu().numpy()[:n, :n] * s)
    norm = np.linalg.norm(A)
    assert _match(kept, np.linalg.eigvals(Hp.double().cpu().numpy()[:n, :n] * s)) < \
        FILTER_TOL[dtype] * norm
    w = np.linalg.eigvals(A)
    assert _match(kept, w[np.argsort(-np.abs(w))][:n]) < FILTER_TOL[dtype] * norm
    assert float((Z - Z0).abs().max()) < SCHUR_ORTH[dtype]


@pytest.mark.cuda
def test_cuda_ritz_kernel_prescale(cuda):
    """The Ritz kernel on a float32 Arnoldi buffer scaled by 2^-60 against its
    plain version: both prescale the block and the eigenvalues."""
    He = _arnoldi_hessenberg(40, 5, ext=True) * 2.0 ** -60
    _hold_ritz_to_plain(cuda, torch.float32, He, 40, 1, 16, 1e-6 * 2.0 ** -60)


# the ordschur kernel's edges: Z leaves shared memory (120 in f64, 170 in
# f32), T does (170 in f64, 241 in f32), a thread owns two rows (257, 300)
ORDSCHUR_NS = [16, 40, 64, 119, 120, 169, 170, 240, 241, 257, 300]


def _ordschur_input(cuda, dtype, n, kind, nz=None):
    """The Schur kernel's ``(T, Z)`` of the spiral operator's Arnoldi
    Hessenberg at ``n`` on the card and a mask: the median selector's (the
    larger half by modulus, as a custom-selector restart keeps) or a seeded
    random one.  With ``nz``, ``Z`` gains ``nz - n`` rows."""
    A = _arnoldi_hessenberg(n, n, 256 if n <= 128 else 512)
    T, Z, wr, wi, _, ok, _ = kernels.hessenberg_schur(torch.from_numpy(A).to(cuda, dtype), n,
                                                      with_z=True, split=True)
    assert bool(ok)
    if kind == "median":
        mod = torch.sqrt(wr.double() ** 2 + wi.double() ** 2)
        mask = mod > torch.median(mod)
    else:
        mask = torch.from_numpy(np.random.default_rng(n).random(n) < 0.5).to(cuda)
    if nz is not None:
        extra = torch.from_numpy(np.random.default_rng(1).standard_normal((nz - n, n)))
        Z = torch.cat([Z, extra.to(cuda, dtype)])
    return T, Z, mask


def _hold_ordschur_to_plain(T, Z, mask):
    """One launch of the ordschur kernel against its plain version (run on
    the host, which rounds as the card does): ``sel'``, ``ok`` and the swap
    count equal; ``T'`` within ``SCHUR_ORTH`` of ``||T||_F``, ``Z'`` within
    ``SCHUR_ORTH`` (``Z`` orthogonal, entries at most 1).  Returns the swap
    count."""
    dtype = T.dtype
    before = _launches("ordschur")
    got = kernels.ordschur(T, Z, mask)
    torch.cuda.synchronize()
    assert _launches("ordschur") == before + 1
    T2, Z2, sel2, ok2, swaps = (t.cpu() for t in got)
    pT2, pZ2, psel2, pok2, pswaps = kernels.ordschur_reference(T.cpu(), Z.cpu(), mask.cpu())
    assert torch.equal(sel2, psel2) and bool(ok2) == bool(pok2) and int(swaps) == int(pswaps)
    norm = float(torch.linalg.norm(T.double()))
    assert float((T2 - pT2).abs().max()) <= SCHUR_ORTH[dtype] * norm
    assert float((Z2 - pZ2).abs().max()) <= SCHUR_ORTH[dtype]
    assert _zero_pattern_ok(T2.double().numpy())
    return int(swaps)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["median", "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", ORDSCHUR_NS)
def test_cuda_ordschur_kernel_matches_plain(cuda, n, dtype, kind):
    T, Z, mask = _ordschur_input(cuda, dtype, n, kind)
    swaps = _hold_ordschur_to_plain(T, Z, mask)
    assert kind == "median" or swaps > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_ordschur_kernel_tall_z(cuda, dtype):
    """``Z`` with more rows than ``T`` (in shared memory at n = 40, in global
    memory beside a shared ``T`` at n = 100)."""
    for n in (40, 100):
        T, Z, mask = _ordschur_input(cuda, dtype, n, "random", nz=n + 37)
        _hold_ordschur_to_plain(T, Z, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [40, 257])
def test_cuda_ordschur_lagging_warp_build_is_bit_equal(cuda, n, dtype):
    """The ordschur kernel's ``T'``, ``Z'``, ``sel'``, ``ok`` and swap count
    from the lagging-warp build, bit for bit the shipping kernel's."""
    from lightkrylov_tpu_torch.ops import _build

    T, Z, mask = _ordschur_input(cuda, dtype, n, "random")
    want = kernels.launch_ordschur(_build.load, T, Z, mask)
    got = kernels.launch_ordschur(_build.load_lagging, T, Z, mask)
    torch.cuda.synchronize()
    assert int(want[4]) > 0 and _bit_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2])
def test_cuda_krylov_schur_restart_makes_no_host_read(cuda, p):
    """A device Krylov-Schur restart (the Schur kernel, the ordschur kernel
    and the restart's small ops) under ``set_sync_debug_mode("error")``, with
    the selection already on the card (and ``k_eff`` a 0-d tensor for
    ``p = 2``)."""
    from lightkrylov_tpu_torch.krylov.krylov_schur import krylov_schur_device

    kdim, N = 30, 200
    rng = np.random.default_rng(p)
    He = np.triu(rng.standard_normal((kdim + p, kdim)), -p)
    X = torch.from_numpy(rng.standard_normal((kdim + p, N))).to(cuda)
    Ht = torch.from_numpy(He).to(cuda)
    w = np.linalg.eigvals(He[:kdim])
    w = w[np.argsort(-np.abs(w))]
    sel_wr, sel_wi = (torch.from_numpy(np.ascontiguousarray(v)).to(cuda) for v in (w.real, w.imag))
    mask = torch.from_numpy(np.abs(w) > np.median(np.abs(w))).to(cuda)
    k = torch.full((), kdim, device=cuda) if p > 1 else None
    krylov_schur_device(X, Ht, sel_wr, sel_wi, mask, p=p, k_eff=k)
    torch.cuda.synchronize()
    before = _launches("ordschur")
    torch.cuda.set_sync_debug_mode("error")
    try:
        krylov_schur_device(X, Ht, sel_wr, sel_wi, mask, p=p, k_eff=k)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _launches("ordschur") == before + 1


@pytest.mark.cuda
def test_cuda_ordschur_refuses_unsupported_tensors(cuda):
    T = torch.eye(4, device=cuda)
    sel = torch.ones(4, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        kernels.ordschur(T.half(), T.half(), sel)
    with pytest.raises(ValueError):
        kernels.ordschur(T, torch.eye(5, device=cuda), sel)
    with pytest.raises(ValueError):
        kernels.ordschur(T, T.double(), sel)
    with pytest.raises(ValueError):
        kernels.ordschur(T, T, sel[:3])
    with pytest.raises(ValueError):
        kernels.ordschur(T, T.cpu(), sel)
