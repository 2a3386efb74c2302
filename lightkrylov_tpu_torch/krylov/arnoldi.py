"""Arnoldi factorization ``A X_k = X_{k+1} H_k``.

Counterpart of :mod:`lightkrylov_tpu.krylov.arnoldi` (reference:
src/Krylov/arnoldi.fypp): Arnoldi with CGS2 against all previous columns,
block Arnoldi with an intra-block QR for block size p > 1, incremental
1-based ``kstart``/``kend`` for restart loops, ``transpose`` through
``rmatvec``, and the invariant-subspace breakdown reported through ``info``
(arnoldi.fypp:34-73; breakdown at :58-71).

Where the JAX package runs a sweep as one ``while_loop`` on the device, this
is a host loop, as in :mod:`.lanczos`.  The breakdown flag ``info`` stays a
0-d int32 tensor on the device; the loop reads it once per step, except
after the last, through :func:`..utils.timer.host_read`, which counts every
read.  Columns of ``X`` and ``H`` are written in place; unfilled columns
stay exactly zero, and on a breakdown the next column is zero too.  A sweep
counts the operator applications of the steps it ran (a step that breaks
down has applied its operator), with timing on or off.  While timing is
on, a step is a span ``arnoldi.step`` holding ``arnoldi.matvec`` and
``arnoldi.orth``.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import constants, vectors
from ..utils.timer import count_applications, host_read, timed, timed_fn
from .gram_schmidt import double_gram_schmidt_step
from .qr import qr as _qr

__all__ = ["arnoldi", "arnoldi_block", "arnoldi_block_step", "arnoldi_step",
           "initialize_arnoldi", "initialize_arnoldi_block"]


def _device(x):
    return pytree.tree_leaves(x)[0].device


def initialize_arnoldi(x0, kdim: int):
    """Buffers: a (kdim+1)-column zero basis whose column 0 is ``x0``
    normalised, and a (kdim+1, kdim) zero ``H`` in ``x0``'s dtype
    (reference: ``initialize_krylov_subspace``, utilities.fypp:34-48)."""
    X = vectors.zeros_basis(x0, kdim + 1)
    vectors.set_column(X, 0, vectors.scal(1.0 / vectors.norm(x0), x0))
    H = torch.zeros((kdim + 1, kdim), dtype=vectors.dtype_of(x0), device=_device(x0))
    return X, H


def initialize_arnoldi_block(x0, kdim: int, p: int, generator=None):
    """Block buffers: a ``(kdim + p)``-column basis whose first block is
    ``x0`` and ``p - 1`` random directions from ``generator``,
    orthonormalized by CGS2 QR (so column 0 spans ``x0``), and a
    ``(kdim + p, kdim)`` zero block Hessenberg (reference:
    ``initialize_krylov_subspace``, utilities.fypp:34-48, blksize p)."""
    X = vectors.zeros_basis(x0, kdim + p)
    if p == 1:
        vectors.set_column(X, 0, vectors.scal(1.0 / vectors.norm(x0), x0))
    else:
        if generator is None:
            generator = torch.Generator(device=_device(x0)).manual_seed(0)
        seed = vectors.rand_basis(generator, vectors.zeros_basis(x0, p))
        vectors.set_column(seed, 0, x0)
        Q, _, _ = _qr(seed, generator=generator)
        vectors.set_columns_block(X, 0, Q)
    H = torch.zeros((kdim + p, kdim), dtype=vectors.dtype_of(x0), device=_device(x0))
    return X, H


def _step_at(A, X, H, k, transpose, tol):
    """:func:`arnoldi_step` at a step index ``k`` held in a 0-d integer
    tensor on the device, with no host read: the columns are gathered and
    written by index, and the CGS2 projection runs against the whole buffer,
    whose columns past ``k`` are exactly zero and add exactly zero
    coefficients (the buffer invariant)."""
    k = k.reshape(1).long()
    with timed("arnoldi.matvec", "BaseKrylov", device=True):
        xk = pytree.tree_map(lambda l: l.index_select(0, k)[0], X)
        v = A.rmatvec(xk) if transpose else A.matvec(xk)
    with timed("arnoldi.orth", "BaseKrylov", device=True):
        v, proj = double_gram_schmidt_step(v, X)
        beta = vectors.norm(v)
        ok = beta > tol
        inv = torch.where(ok, 1.0 / torch.where(beta == 0, torch.ones_like(beta), beta),
                          torch.zeros_like(beta))
        v = vectors.scal(inv, v)
        pytree.tree_map(lambda Xl, vl: Xl.index_copy_(0, k + 1, vl.unsqueeze(0)), X, v)
        col = proj.to(H.dtype).clone()
        col.index_copy_(0, k + 1,
                        torch.where(ok, beta, torch.zeros_like(beta)).to(H.dtype).reshape(1))
        H.index_copy_(1, k, col.reshape(-1, 1))
    return X, H, beta


def arnoldi_step(A, X, H, k, transpose: bool = False, tol: float = 0.0):
    """One Arnoldi step: extend a k-column factorization to k+1 (0-based
    ``k``; column ``k`` of ``X`` is filled).  Writes ``H[:, k]`` (the CGS2
    coefficients and ``H[k+1, k] = beta``) and column ``k+1`` of ``X`` (the
    next unit vector, zero on breakdown) in place and returns
    ``(X, H, beta)``, ``beta`` a 0-d real tensor (reference:
    arnoldi.fypp:34-73 for p = 1).  ``k`` may be a 0-d integer tensor on the
    device, as a device restart leaves it; the step then projects against
    the whole buffer."""
    with timed("arnoldi.step", "BaseKrylov", device=True):
        if isinstance(k, torch.Tensor):
            return _step_at(A, X, H, k, transpose, tol)
        with timed("arnoldi.matvec", "BaseKrylov", device=True):
            xk = vectors.get_column(X, k)
            v = A.rmatvec(xk) if transpose else A.matvec(xk)
        with timed("arnoldi.orth", "BaseKrylov", device=True):
            v, proj = double_gram_schmidt_step(v, vectors.lead(X, k + 1))
            beta = vectors.norm(v)
            ok = beta > tol
            inv = torch.where(ok, 1.0 / torch.where(beta == 0, torch.ones_like(beta), beta),
                              torch.zeros_like(beta))
            vectors.set_column(X, k + 1, vectors.scal(inv, v))
            H[:, k] = 0
            H[: k + 1, k] = proj.to(H.dtype)
            H[k + 1, k] = torch.where(ok, beta, torch.zeros_like(beta)).to(H.dtype)
        return X, H, beta


@timed_fn("krylov.arnoldi", "BaseKrylov")
def arnoldi(A, X, H, kstart: int = 1, kend: int | None = None, transpose: bool = False,
            tol: float | None = None):
    """Grow the Arnoldi factorization from step ``kstart`` to ``kend``
    (1-based, inclusive, the reference's convention, arnoldi.fypp:8-33), in
    place.  Returns ``(X, H, info)``, ``info`` a 0-d int32 tensor on the
    device: ``k`` on an invariant-subspace breakdown at step ``k``
    (``beta <= tol``), ``-k`` on a NaN ``beta``, else 0 (reference:
    arnoldi.fypp:66-71; qr.fypp:72-78)."""
    kdim = H.shape[1]
    if kend is None:
        kend = kdim
    if tol is None:
        tol = constants.atol(H.dtype)
    info = torch.zeros((), dtype=torch.int32, device=H.device)
    k = kstart - 1
    while k < kend:
        X, H, beta = arnoldi_step(A, X, H, k, transpose=transpose, tol=tol)
        info = torch.where(beta <= tol, k + 1, info).to(torch.int32)
        info = torch.where(torch.isnan(beta), -(k + 1), info).to(torch.int32)
        k += 1
        if k < kend and int(host_read(info)) != 0:
            break
    count_applications(A, k - (kstart - 1), "rmatvec" if transpose else "matvec")
    return X, H, info


def arnoldi_block_step(A, X, H, s: int, p: int, transpose: bool = False,
                       tol: float = 0.0, generator=None):
    """One block Arnoldi step at column offset ``s``: the newest filled
    block is columns ``s .. s+p-1``; the step fills columns ``s+p ..
    s+2p-1`` of ``X`` and ``H[:, s:s+p]`` in place.  ``s`` need not be a
    multiple of ``p``; it needs ``s <= kdim - p``.

    The newest block goes through ``matvec_basis``, is CGS2-projected
    against the ``s + p`` filled columns, and its intra-block QR gives the
    subdiagonal block ``H[s+p:s+2p, s:s+p]``.  Returns ``(X, H, res)``,
    ``res`` the smallest ``|R[j, j]|`` of the new block as a 0-d tensor,
    the block breakdown indicator (reference: arnoldi.fypp:34-73 with
    blksize p > 1)."""
    with timed("arnoldi.step", "BaseKrylov", device=True):
        with timed("arnoldi.matvec", "BaseKrylov", device=True):
            blk_in = pytree.tree_map(lambda l: l[s:s + p], X)
            blk = A.rmatvec_basis(blk_in) if transpose else A.matvec_basis(blk_in)
        with timed("arnoldi.orth", "BaseKrylov", device=True):
            blk, proj = double_gram_schmidt_step(blk, vectors.lead(X, s + p))
            H[:, s:s + p] = 0
            H[: s + p, s:s + p] = proj.to(H.dtype)
            Q, R, _ = _qr(blk, tol=tol, generator=generator)
            vectors.set_columns_block(X, s + p, Q)
            H[s + p:s + 2 * p, s:s + p] = R.to(H.dtype)
        return X, H, torch.min(torch.abs(torch.diagonal(R)))


@timed_fn("krylov.arnoldi_block", "BaseKrylov")
def arnoldi_block(A, X, H, p: int, kstart: int = 1, kend: int | None = None,
                  transpose: bool = False, tol: float | None = None, generator=None):
    """Block Arnoldi with block size ``p``, in place.  ``X`` holds
    ``kdim + p`` stacked columns and ``H`` is ``(kdim + p, kdim)`` with
    ``kdim`` a multiple of ``p``; ``kstart - 1`` and ``kend`` are multiples
    of ``p`` (1-based, inclusive).  Returns ``(X, H, info)``, ``info`` a
    0-d int32 tensor: the number of processed columns at a block breakdown
    (smallest ``|diag R|`` of a new block at or below ``tol``), a negative
    value on NaN, else 0 (reference: arnoldi.fypp:34-73 with blksize p)."""
    kdim = H.shape[1]
    if kdim % p:
        raise ValueError(f"kdim = {kdim} is not a multiple of the block size {p}")
    if tol is None:
        tol = constants.atol(H.dtype)
    b0 = (kstart - 1) // p
    b1 = (kdim if kend is None else kend) // p
    info = torch.zeros((), dtype=torch.int32, device=H.device)
    b = b0
    while b < b1:
        X, H, res = arnoldi_block_step(A, X, H, b * p, p, transpose=transpose, tol=tol,
                                       generator=generator)
        info = torch.where((info == 0) & (res <= tol), (b + 1) * p, info).to(torch.int32)
        info = torch.where(torch.isnan(res), -(b * p + 1), info).to(torch.int32)
        b += 1
        if b < b1 and int(host_read(info)) != 0:
            break
    count_applications(A, (b - b0) * p, "rmatvec" if transpose else "matvec")
    return X, H, info
