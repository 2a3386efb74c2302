"""The port's QR, Arnoldi and Krylov-Schur restart against the JAX
package's, on the same seeded numpy inputs.

Identities (``A X_k = X_{k+1} H_k``, ``X = Q R``, orthonormality) are held
to ``rtol`` of ``constants.py`` in all four dtypes; the factorizations
themselves are compared with the JAX ones in float64 and complex128, where
both packages run the same arithmetic up to rounding (1e-12).  Random
replacement columns differ between the packages (a ``torch.Generator``
against a PRNG key), so rank-deficient cases compare what does not depend
on them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightkrylov_tpu as lk
import lightkrylov_tpu_torch as lt
from lightkrylov_tpu import krylov as jkr
from lightkrylov_tpu.krylov.arnoldi import initialize_arnoldi_block as j_init_block
from lightkrylov_tpu_torch import krylov as tkr
from lightkrylov_tpu_torch.utils.logger import LightKrylovError

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)

N, KDIM = 128, 12
PARITY = 1e-12


def _rand(dtype, rng, shape):
    a = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.linalg.norm(np.asarray(got) - ref) / max(np.linalg.norm(ref), 1e-300)


def _pair(A, x0, kdim=KDIM, **kw):
    """``(X, H, info)`` of one Arnoldi run in each package."""
    Xj, Hj = jkr.initialize_arnoldi(jnp.asarray(x0), kdim)
    Xj, Hj, ij = jkr.arnoldi(lk.DenseOperator(jnp.asarray(A)), Xj, Hj, **kw)
    Xt, Ht = lt.initialize_arnoldi(torch.from_numpy(x0), kdim)
    Xt, Ht, it = lt.arnoldi(lt.DenseOperator(torch.from_numpy(A)), Xt, Ht, **kw)
    return (np.array(Xj), np.array(Hj), int(ij)), (Xt.numpy(), Ht.numpy(), it)


# -- QR -----------------------------------------------------------------------

def test_qr_matches_jax(dtype):
    rng = np.random.default_rng(1)
    X = _rand(dtype, rng, (6, N))
    Qj, Rj, ij = jkr.qr(jnp.asarray(X))
    Q, R, info = lt.qr(torch.from_numpy(X))
    tol = lk.rtol(dtype)
    assert info == int(ij) == 0
    assert bool(tkr.is_orthonormal(Q, rtol=tol))
    assert _rel(R.numpy().T @ Q.numpy(), X) < tol
    assert not np.tril(R.numpy(), -1).any()
    limit = PARITY if np.dtype(dtype).itemsize >= 16 or dtype == np.float64 else 10 * tol
    assert _rel(Q.numpy(), Qj) < limit and _rel(R.numpy(), Rj) < limit


def test_qr_breakdown_replacement(dtype):
    """A collinear second column: info = 2, R[1, 1] = 0, and the random
    replacement keeps Q orthonormal (reference: qr.fypp:116-167)."""
    rng = np.random.default_rng(2)
    x, r = _rand(dtype, rng, (N,)), _rand(dtype, rng, (N,))
    X = np.stack([x, 2.0 * x, r])
    tol = float(np.sqrt(lk.atol(dtype)))
    _, Rj, ij = jkr.qr(jnp.asarray(X), tol=tol)
    Q, R, info = lt.qr(torch.from_numpy(X), tol=tol, generator=torch.Generator().manual_seed(5))
    assert info == int(ij) == 2
    assert R[1, 1] == 0 and bool(tkr.is_orthonormal(Q, rtol=lk.rtol(dtype)))
    assert _rel(R.numpy()[:, 0], np.asarray(Rj)[:, 0]) < 10 * lk.rtol(dtype)


def test_qr_nan_is_fatal():
    X = np.random.default_rng(0).standard_normal((4, 16))
    X[2, 3] = np.nan
    assert lt.qr(torch.from_numpy(X))[2] == int(jkr.qr(jnp.asarray(X))[2]) == -4
    assert lt.qr_pivoted(torch.from_numpy(X))[3] < 0
    with pytest.raises(LightKrylovError):
        lt.check_info(lt.qr(torch.from_numpy(X))[2], "qr")


@pytest.mark.parametrize("rank", [6, 3], ids=["full", "rank3"])
def test_qr_pivoted_matches_jax(dtype_dp, rank):
    rng = np.random.default_rng(3)
    B = _rand(dtype_dp, rng, (rank, N))
    X = _rand(dtype_dp, rng, (6, rank)) @ B  # rank-r basis of 6 columns
    Qj, Rj, pj, ij = jkr.qr_pivoted(jnp.asarray(X))
    Q, R, perm, info = lt.qr_pivoted(torch.from_numpy(X))
    assert info == int(ij) == 6 - rank
    assert bool(tkr.is_orthonormal(Q, rtol=lk.rtol(dtype_dp)))
    Xp = X[perm.numpy()]
    assert _rel(R.numpy().T @ Q.numpy(), Xp) < 10 * lk.rtol(dtype_dp)
    d = np.abs(np.diag(R.numpy()))
    assert np.all(d[:rank][:-1] >= d[:rank][1:])
    # the pivots over the numerical rank, and what they determine
    assert np.array_equal(perm.numpy()[:rank], np.asarray(pj)[:rank])
    assert _rel(Q.numpy()[:rank], np.asarray(Qj)[:rank]) < PARITY
    assert _rel(R.numpy()[:rank, :rank], np.asarray(Rj)[:rank, :rank]) < PARITY


def test_cholesky_qr2_matches_jax(dtype):
    rng = np.random.default_rng(4)
    X = _rand(dtype, rng, (6, N))
    Qj, Rj, ij = jkr.cholesky_qr2(jnp.asarray(X))
    Q, R, info = lt.cholesky_qr2(torch.from_numpy(X))
    tol = lk.rtol(dtype)
    assert info == ij == 0
    assert bool(tkr.is_orthonormal(Q, rtol=tol)) and _rel(R.numpy().T @ Q.numpy(), X) < tol
    limit = PARITY if dtype in (np.float64, np.complex128) else 10 * tol
    assert _rel(Q.numpy(), Qj) < limit and _rel(R.numpy(), Rj) < limit


def test_cholesky_qr2_rank_deficient_fallback(dtype_dp):
    """A zero column breaks the Cholesky factorization: info = -1 in both
    packages, and ``orthonormalize_basis`` falls back to CGS2."""
    rng = np.random.default_rng(5)
    x, r = _rand(dtype_dp, rng, (N,)), _rand(dtype_dp, rng, (N,))
    X = np.stack([x, np.zeros_like(x), r])
    assert lt.cholesky_qr2(torch.from_numpy(X))[2] == jkr.cholesky_qr2(jnp.asarray(X))[2] == -1
    Q = lt.orthonormalize_basis(torch.from_numpy(X), method="cholqr2")
    assert bool(lt.is_orthonormal(Q, rtol=lk.rtol(dtype_dp)))
    Xc = np.stack([x, 2.0 * x, r])
    Qc, _, infoc = lt.cholesky_qr2(torch.from_numpy(Xc))
    assert infoc == -1 or bool(lt.is_orthonormal(Qc))


def test_basis_utilities_match_jax():
    rng = np.random.default_rng(6)
    X = rng.standard_normal((5, 7, 3))
    perm = np.array([3, 0, 4, 1, 2])
    assert np.array_equal(lt.permcols(torch.from_numpy(X), perm).numpy(),
                          np.asarray(jkr.permcols(jnp.asarray(X), perm)))
    C = rng.standard_normal((4, 5))
    assert np.array_equal(lt.permcols(torch.from_numpy(C), perm).numpy(), C[:, perm])
    assert np.array_equal(lt.invperm(perm).numpy(), np.asarray(jkr.invperm(perm)))
    # one seed vector, then a seed block
    buf = np.zeros((6, 7, 3))
    seed = rng.standard_normal((7, 3))
    Xt = lt.initialize_krylov_subspace(torch.from_numpy(buf), torch.from_numpy(seed))
    Xj = jkr.initialize_krylov_subspace(jnp.asarray(buf), jnp.asarray(seed))
    assert _rel(Xt.numpy(), Xj) < PARITY and not Xt[1:].any()
    block = rng.standard_normal((2, 7, 3))
    Xt = lt.initialize_krylov_subspace(torch.from_numpy(buf), torch.from_numpy(block))
    Xj = jkr.initialize_krylov_subspace(jnp.asarray(buf), jnp.asarray(block))
    assert _rel(Xt.numpy(), Xj) < PARITY and not Xt[2:].any()
    assert lt.initialize_krylov_subspace(torch.from_numpy(buf)).abs().sum() == 0
    B = lt.initialize_random_orthonormal_basis(torch.Generator().manual_seed(1),
                                               torch.zeros(50, dtype=torch.float64), 4)
    assert B.shape == (4, 50) and bool(lt.is_orthonormal(B, rtol=1e-12))
    assert not bool(lt.is_orthonormal(torch.from_numpy(block.reshape(2, -1))))


# -- Arnoldi -------------------------------------------------------------------

def test_arnoldi_identity(dtype):
    """``A X_k = X_{k+1} H_k`` and an orthonormal basis (reference:
    TestKrylov.fypp:183-240); float64/complex128 equal the JAX run."""
    rng = np.random.default_rng(7)
    A, x0 = _rand(dtype, rng, (N, N)), _rand(dtype, rng, (N,))
    (Xj, Hj, ij), (X, H, info) = _pair(A, x0)
    assert info.dtype == torch.int32 and int(info) == ij == 0
    tol = lk.rtol(dtype)
    assert np.linalg.norm(A @ X[:KDIM].T - X.T @ H) / np.linalg.norm(H) < tol
    assert bool(lt.is_orthonormal(torch.from_numpy(X), rtol=tol))
    if dtype in (np.float64, np.complex128):
        assert _rel(H, Hj) < PARITY and _rel(X, Xj) < PARITY


def test_arnoldi_incremental_matches_full(dtype):
    rng = np.random.default_rng(8)
    A = torch.from_numpy(_rand(dtype, rng, (N, N)))
    x0 = torch.from_numpy(_rand(dtype, rng, (N,)))
    op = lt.DenseOperator(A)
    Xf, Hf, _ = lt.arnoldi(op, *lt.initialize_arnoldi(x0, KDIM))
    Xi, Hi = lt.initialize_arnoldi(x0, KDIM)
    for k in range(1, KDIM + 1):
        Xi, Hi, _ = lt.arnoldi(op, Xi, Hi, kstart=k, kend=k)
    assert np.allclose(Hf.numpy(), Hi.numpy(), atol=10 * lk.rtol(dtype))
    assert np.allclose(Xf.numpy(), Xi.numpy(), atol=10 * lk.rtol(dtype))


def test_arnoldi_invariant_subspace(dtype):
    """A 3-dimensional invariant subspace holding x0: info <= 3 as in JAX,
    and the columns past the breakdown stay zero."""
    rng = np.random.default_rng(5)
    A = np.zeros((N, N))
    A[:3, :3] = rng.standard_normal((3, 3))
    A[3:, 3:] = rng.standard_normal((N - 3, N - 3))
    A = A.astype(dtype)
    x0 = np.zeros(N, dtype)
    x0[0] = 1.0
    tol = 1e-4 if np.dtype(dtype).itemsize <= 8 else 1e-10
    (_, _, ij), (X, H, info) = _pair(A, x0, tol=tol)
    assert 0 < int(info) == ij <= 3
    assert H[int(info), int(info) - 1] == 0 and not X[int(info):].any()


def test_arnoldi_nan_is_fatal():
    op = lt.MatvecOperator(lambda x: x * float("nan"))
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal(16))
    _, _, info = lt.arnoldi(op, *lt.initialize_arnoldi(x0, 4))
    assert int(info) == -1
    with pytest.raises(LightKrylovError, match="arnoldi"):
        lt.eigs(op, 2, x0=x0, kdim=4)


def test_arnoldi_transpose_matches_jax(dtype_dp):
    """``transpose=True`` factorizes ``A^H`` through ``rmatvec``."""
    rng = np.random.default_rng(9)
    A, x0 = _rand(dtype_dp, rng, (N, N)), _rand(dtype_dp, rng, (N,))
    (Xj, Hj, _), (X, H, _) = _pair(A, x0, transpose=True)
    assert _rel(H, Hj) < PARITY and _rel(X, Xj) < PARITY
    _, (_, Ha, _) = _pair(np.ascontiguousarray(A.conj().T), x0)
    assert _rel(H, Ha) < PARITY


def test_block_arnoldi_matches_jax(dtype):
    """Block Arnoldi (p = 2): the identity ``A X_k = X_{k+p} H`` in all four
    dtypes, one-shot against block by block, and the JAX run in double."""
    p, kdim = 2, 8
    rng = np.random.default_rng(10)
    A, B = _rand(dtype, rng, (N, N)), _rand(dtype, rng, (p, N))
    Q0, _, _ = lt.qr(torch.from_numpy(B))
    X = lt.zeros_basis(torch.zeros(N, dtype=Q0.dtype), kdim + p)
    lt.vectors.set_columns_block(X, 0, Q0)
    H = torch.zeros((kdim + p, kdim), dtype=Q0.dtype)
    op = lt.DenseOperator(torch.from_numpy(A))
    X2, H2 = X.clone(), H.clone()
    X, H, info = lt.arnoldi_block(op, X, H, p)
    assert int(info) == 0
    tol = lk.rtol(dtype)
    Xm, Hm = X.numpy(), H.numpy()
    assert np.linalg.norm(A @ Xm[:kdim].T - Xm.T @ Hm) / np.linalg.norm(Hm) < tol
    assert bool(lt.is_orthonormal(X, rtol=tol))
    for b in range(kdim // p):
        X2, H2, _ = lt.arnoldi_block(op, X2, H2, p, kstart=b * p + 1, kend=(b + 1) * p)
    assert np.allclose(H2.numpy(), Hm, atol=10 * tol)
    if dtype in (np.float64, np.complex128):
        Xj = jnp.zeros((kdim + p, N), dtype).at[:p].set(jnp.asarray(Q0.numpy()))
        Xj, Hj, ij = jkr.arnoldi_block(lk.DenseOperator(jnp.asarray(A)), Xj,
                                       jnp.zeros((kdim + p, kdim), dtype), p)
        assert int(ij) == 0 and _rel(Hm, Hj) < PARITY and _rel(Xm, Xj) < PARITY


def test_initialize_arnoldi_block_keeps_x0():
    x0 = np.random.default_rng(11).standard_normal(40)
    X, H = tkr.initialize_arnoldi_block(torch.from_numpy(x0), 6, 3,
                                        generator=torch.Generator().manual_seed(2))
    Xj, Hj = j_init_block(jnp.asarray(x0), 6, 3)
    assert X.shape == np.asarray(Xj).shape == (9, 40) and H.shape == Hj.shape == (9, 6)
    assert _rel(X[0].numpy(), np.asarray(Xj)[0]) < PARITY
    assert abs(abs(float(X[0] @ torch.from_numpy(x0))) - np.linalg.norm(x0)) < 1e-12
    assert bool(lt.is_orthonormal(X[:3], rtol=1e-12)) and not X[3:].any()


# -- Krylov-Schur --------------------------------------------------------------

def _arnoldi_then_restart(dtype, select=None, seed=12):
    """One Arnoldi run (JAX) and its restart in each package from that same
    factorization: a complex Schur form is unique only up to the phases of
    its vectors, which rounding-level differences in ``H`` can change."""
    rng = np.random.default_rng(seed)
    A, x0 = _rand(dtype, rng, (N, N)), _rand(dtype, rng, (N,))
    (Xj, Hj, _), _ = _pair(A, x0)
    Xcj, Hcj, nj = jkr.krylov_schur(jnp.asarray(Xj), jnp.asarray(Hj), select)
    Xc, Hc, n = lt.krylov_schur(torch.from_numpy(Xj), torch.from_numpy(Hj), select)
    return A, Hj, (Xcj, Hcj, nj), (Xc, Hc, n)


@pytest.mark.parametrize("select", [None, lambda w: np.real(w) > np.median(np.real(w))],
                         ids=["median", "real-part"])
def test_krylov_schur_matches_jax(dtype_dp, select):
    """After compression the identity holds on ``n`` columns, the basis is
    orthonormal, and the result equals JAX's (reference:
    TestKrylov.fypp:301-347)."""
    A, _, (Xcj, Hcj, nj), (Xc, Hc, n) = _arnoldi_then_restart(dtype_dp, select)
    assert n == nj and 1 <= n < KDIM
    Xm, Hm = Xc.numpy(), Hc.numpy()
    assert np.linalg.norm(A @ Xm[:n].T - Xm[: n + 1].T @ Hm[: n + 1, :n]) < 1e-8 * np.linalg.norm(A)
    assert not Xm[n + 1:].any() and not Hm[n + 1:].any()
    G = lt.gram(Xc).numpy()[: n + 1, : n + 1]
    assert np.allclose(G, np.eye(n + 1), atol=1e-8)
    assert _rel(Hm, Hcj) < PARITY and _rel(Xm, Xcj) < PARITY


def test_krylov_schur_continuation_matches_jax(dtype_dp):
    A, _, (Xcj, Hcj, nj), (Xc, Hc, n) = _arnoldi_then_restart(dtype_dp)
    Xr, Hr, info = lt.arnoldi(lt.DenseOperator(torch.from_numpy(A)), Xc, Hc, kstart=n + 1)
    Xrj, Hrj, infoj = jkr.arnoldi(lk.DenseOperator(jnp.asarray(A)), Xcj, Hcj, kstart=nj + 1)
    assert int(info) == int(infoj) == 0
    Xm, Hm = Xr.numpy(), Hr.numpy()
    assert np.linalg.norm(A @ Xm[:KDIM].T - Xm.T @ Hm) < 1e-8 * np.linalg.norm(A)
    assert bool(lt.is_orthonormal(Xr, rtol=1e-8))
    assert _rel(Hm, Hrj) < 1e-10 and _rel(Xm, Xrj) < 1e-10


def test_krylov_schur_clamp_matches_jax():
    """A selector that keeps nothing (the median selector, when every Ritz
    value has one modulus) gives ``n = 0``, which both packages clamp to 1
    though the leading block of this Schur form is 2x2: the clamp splits
    it and drops ``T[1, 0]`` (ROADMAP F8)."""
    def none(w):
        return np.zeros(len(w), bool)

    _, Hj, (Xcj, Hcj, nj), (Xc, Hc, n) = _arnoldi_then_restart(np.float64, none, seed=2)
    T, _, kept = lt.linalg.schur_select(Hj[:KDIM, :KDIM], none)
    assert kept == 0 and T[1, 0] != 0
    assert n == nj == 1
    assert _rel(Hc.numpy(), Hcj) < PARITY and _rel(Xc.numpy(), Xcj) < PARITY
