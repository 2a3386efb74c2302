"""Lanczos tridiagonalization for symmetric/Hermitian operators.

Counterpart of :mod:`lightkrylov_tpu.krylov.lanczos` (reference:
src/Krylov/lanczos.fypp): the three-term recurrence **with full
re-orthogonalization** against the basis at each step by CGS2
(lanczos.fypp:46-64), ``T[k+1, k] = beta`` and the breakdown exit
(:29-40).  ``A`` is trusted to be symmetric/Hermitian.

Where the JAX package runs the sweep as one ``while_loop`` on the device,
this is a host loop.  The breakdown flag ``info`` stays a 0-d int32 tensor
on the device; the loop reads it once per step, except after the last,
through :func:`..utils.timer.host_read`, which counts every read.  Basis
columns and ``T`` are written in place, and each CGS2 reads only the filled
columns ``X[:k+1]``.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import constants, vectors
from ..utils.timer import host_read, timed_fn
from .arnoldi import _count_steps
from .gram_schmidt import double_gram_schmidt_step

__all__ = ["lanczos", "lanczos_step", "initialize_lanczos"]


def initialize_lanczos(x0, kdim: int):
    """Buffers: a (kdim+1)-column zero basis whose column 0 is ``x0``
    normalised, and a (kdim+1, kdim) zero ``T`` in ``x0``'s dtype."""
    X = vectors.zeros_basis(x0, kdim + 1)
    vectors.set_column(X, 0, vectors.scal(1.0 / vectors.norm(x0), x0))
    T = torch.zeros((kdim + 1, kdim), dtype=vectors.dtype_of(x0),
                    device=pytree.tree_leaves(x0)[0].device)
    return X, T


def lanczos_step(A, X, T, k: int, tol: float = 0.0):
    """One Lanczos step with full CGS2 re-orthogonalization (reference:
    lanczos.fypp:46-64); writes column ``k+1`` of ``X`` and column ``k`` of
    ``T`` in place and returns ``(X, T, beta)``, ``beta`` a 0-d real tensor.

    The CGS2 coefficients subsume the three-term recurrence:
    ``alpha = proj[k]`` and ``beta_{k-1} = proj[k-1]``."""
    rdt = constants.real_dtype_of(T.dtype)
    v = A.matvec(vectors.get_column(X, k))
    v, proj = double_gram_schmidt_step(v, vectors.lead(X, k + 1))
    beta = vectors.norm(v)
    ok = beta > tol
    inv = torch.where(ok, 1.0 / torch.where(beta == 0, torch.ones_like(beta), beta),
                      torch.zeros_like(beta))
    vectors.set_column(X, k + 1, vectors.scal(inv.to(rdt), v))
    T[:, k] = 0
    T[: k + 1, k] = proj.to(T.dtype)
    T[k + 1, k] = torch.where(ok, beta, torch.zeros_like(beta)).to(T.dtype)
    return X, T, beta


@timed_fn("krylov.lanczos", "BaseKrylov")
def lanczos(A, X, T, kstart: int = 1, kend: int | None = None, tol: float | None = None):
    """Grow the Lanczos factorization ``A X_k = X_{k+1} T_k`` from step
    ``kstart`` to ``kend`` (1-based, inclusive), in place.  Returns
    ``(X, T, info)``, ``info`` a 0-d int32 tensor on the device: ``k`` on an
    invariant-subspace breakdown at step ``k`` (``beta <= tol``), ``-k`` on
    a NaN ``beta``, else 0 (reference: lanczos.fypp:8-45; qr.fypp:72-78)."""
    kdim = T.shape[1]
    if kend is None:
        kend = kdim
    if tol is None:
        tol = constants.atol(T.dtype)
    info = torch.zeros((), dtype=torch.int32, device=T.device)
    k = kstart - 1
    while k < kend:
        X, T, beta = lanczos_step(A, X, T, k, tol=tol)
        info = torch.where(beta <= tol, k + 1, info).to(torch.int32)
        info = torch.where(torch.isnan(beta), -(k + 1), info).to(torch.int32)
        k += 1
        if k < kend and int(host_read(info)) != 0:
            break
    _count_steps(A, info, kstart, kend, 1, "matvec")
    return X, T, info
