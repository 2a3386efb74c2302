"""QR factorization of a stacked basis, with and without column pivoting.

Counterpart of :mod:`lightkrylov_tpu.krylov.qr` (reference:
src/Krylov/qr.fypp): CGS2 QR column by column with breakdown handling (a
collinear column is replaced by a random vector orthogonalized against the
processed columns, its diagonal entry of ``R`` is zero and ``info`` records
the event, qr.fypp:116-167), rank-revealing QR with column pivoting on the
running column norms (qr.fypp:32-107,176-202), and CholeskyQR2.

The column loops run on the host.  Whether a column broke down is decided
on the host from its norm, one counted read per column, where the JAX
package chose the branch inside a ``lax.cond``; the replacement draws come
from a ``torch.Generator`` (default: seeded with 0 on the basis's device)
and are drawn before the loop, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import constants, vectors
from ..utils.timer import host_read, timed_fn
from .gram_schmidt import double_gram_schmidt_step

__all__ = ["qr", "qr_pivoted", "cholesky_qr2"]


def _device(X):
    return pytree.tree_leaves(X)[0].device


def _replacement_basis(generator, X):
    """Random candidates, one per column, for breakdown repair."""
    if generator is None:
        generator = torch.Generator(device=_device(X)).manual_seed(0)
    return vectors.rand_basis(generator, X)


def _orthonormal_column(v, beta, Q, j, repl, broke: bool):
    """Column ``j`` of ``Q``: ``v / beta``, or on breakdown the replacement
    candidate orthogonalized against the ``j`` processed columns and
    normalised (zero if it vanishes too)."""
    if broke:
        v, _ = double_gram_schmidt_step(vectors.get_column(repl, j), vectors.lead(Q, j))
        beta = vectors.norm(v)
    inv = torch.where(beta > 0, 1.0 / torch.where(beta == 0, torch.ones_like(beta), beta),
                      torch.zeros_like(beta))
    return vectors.scal(inv, v)


def _cholqr_pass(X):
    """One CholeskyQR pass: ``X = Q R`` with ``R = chol(X^H X)^H``.
    Returns ``(Q, R, ok)``, ``ok`` a 0-d bool tensor that is false when the
    Cholesky factorization broke down."""
    G = vectors.gram(X)
    L, info = torch.linalg.cholesky_ex(G)
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    # Q = X L^{-H}: column i of Q is sum_j C[j, i] X_j with C = (L^H)^{-1}
    C = torch.linalg.solve_triangular(L.mH, eye, upper=True)
    return vectors.linear_combination(X, C), L.mH, info == 0


def cholesky_qr2(X):
    """CholeskyQR2 of a stacked basis -> ``(Q, R, info)``: two Gram-matrix
    passes, each one matrix product over the basis, restore orthonormality
    to working precision.  No reference counterpart; the reference's only
    basis QR is the CGS2 loop (qr.fypp:116-167).

    ``info = 0`` on success and ``-1`` when the Gram matrix is numerically
    rank-deficient (the Cholesky factorization breaks down or leaves
    non-finite values) or ``||Q^H Q - I||_F`` misses the basis dtype's own
    ``rtol``; :func:`qr` then covers the case.  One host read."""
    Q1, R1, ok1 = _cholqr_pass(X)
    Q, R2, ok2 = _cholqr_pass(Q1)
    R = R2 @ R1
    G = vectors.gram(Q)
    err = torch.linalg.norm(G - torch.eye(G.shape[0], dtype=G.dtype, device=G.device))
    finite = ok1 & ok2 & torch.isfinite(R).all()
    for leaf in pytree.tree_leaves(Q):
        finite = finite & torch.isfinite(leaf).all()
    err = torch.where(finite, err, torch.full_like(err, float("inf")))
    rdt = constants.real_dtype_of(vectors.dtype_of(X))
    ok = float(host_read(err)) < constants.rtol(rdt)
    return Q, R, 0 if ok else -1


@timed_fn("krylov.qr", "BaseKrylov")
def qr(X, tol: float | None = None, generator: torch.Generator | None = None):
    """CGS2 QR of the stacked basis ``X`` -> ``(Q, R, info)``.

    ``Q`` has orthonormal columns spanning ``X`` (collinear columns replaced
    by random orthonormalized directions, with ``R[j, j] = 0``), ``R`` is
    upper triangular, and ``info`` is the 1-based index of the first
    replacement, 0 if none, or ``-j`` when the norm of column ``j`` is NaN
    (reference: qr.fypp:72-78,116-167).  ``info`` is a Python int."""
    k = vectors.basis_size(X)
    dt = vectors.dtype_of(X)
    if tol is None:
        tol = constants.atol(constants.real_dtype_of(dt))
    repl = _replacement_basis(generator, X)
    Q = vectors.zero_basis_like(X)
    R = torch.zeros((k, k), dtype=dt, device=_device(X))
    info = 0
    for j in range(k):
        v, proj = double_gram_schmidt_step(vectors.get_column(X, j), vectors.lead(Q, j))
        beta = vectors.norm(v)
        b = float(host_read(beta))
        broke = b < tol
        vectors.set_column(Q, j, _orthonormal_column(v, beta, Q, j, repl, broke))
        R[:j, j] = proj
        R[j, j] = 0.0 if broke else beta.to(dt)
        if info == 0 and broke:
            info = j + 1
        if b != b:  # NaN: corrupt data, fatal
            info = -(j + 1)
    return Q, R, info


@timed_fn("krylov.qr_pivoted", "BaseKrylov")
def qr_pivoted(X, tol: float | None = None, generator: torch.Generator | None = None):
    """Rank-revealing CGS2 QR with column pivoting -> ``(Q, R, perm, info)``
    with ``X[perm] = Q R`` column by column, ``perm`` a 0-based int64
    tensor (reference: qr.fypp:32-107,176-202: running squared column
    norms, the largest remaining one as pivot, column swaps).

    ``info`` is the number of columns replaced after the rank ran out, or
    ``-j`` at the first column ``j`` whose norm is NaN.  The pivot and the
    breakdown test are read to the host, one read per column."""
    k = vectors.basis_size(X)
    dt = vectors.dtype_of(X)
    if tol is None:
        tol = constants.atol(constants.real_dtype_of(dt))
    repl = _replacement_basis(generator, X)
    W = vectors.copy(X)
    Rii = torch.real(torch.diagonal(vectors.gram(X))).clone()
    Q = vectors.zero_basis_like(X)
    R = torch.zeros((k, k), dtype=dt, device=_device(X))
    perm = torch.arange(k)
    info = 0
    for j in range(k):
        masked = Rii.clone()
        masked[:j] = -float("inf")
        piv = int(host_read(torch.argmax(masked)))
        if piv != j:
            sw, ws = [j, piv], [piv, j]
            for leaf in pytree.tree_leaves(W):
                leaf[sw] = leaf[ws].clone()
            R[:, sw] = R[:, ws].clone()
            Rii[sw] = Rii[ws].clone()
            perm[sw] = perm[ws].clone()
        v, proj = double_gram_schmidt_step(vectors.get_column(W, j), vectors.lead(Q, j))
        beta = vectors.norm(v)
        b = float(host_read(beta))
        broke = b**2 < tol
        qj = _orthonormal_column(v, beta, Q, j, repl, broke)
        vectors.set_column(Q, j, qj)
        R[:j, j] = proj
        R[j, j] = 0.0 if broke else beta.to(dt)
        # downdate the running column norms: |w_i|^2 -= |q_j^H w_i|^2
        Rii -= torch.abs(vectors.innerprod(W, qj)) ** 2
        Rii[j] = -float("inf")
        info += int(broke)
        if b != b and info >= 0:
            info = -(j + 1)
    return Q, R, perm, info
