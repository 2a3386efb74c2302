"""Golub-Kahan (Lanczos) bidiagonalization.

Counterpart of :mod:`lightkrylov_tpu.krylov.bidiag` (reference:
src/Krylov/golub_kahan.fypp): alternating ``v = A^H u`` and ``u = A v``
steps with full CGS2 re-orthogonalization of both bases, a lower
bidiagonal ``B`` with ``B[k, k] = alpha`` and ``B[k+1, k] = beta``, and a
breakdown exit when either norm vanishes (golub_kahan.fypp:26-61).  ``U``
lives in the codomain of ``A`` and ``V`` in its domain, so rectangular
operators work.

Where the JAX package runs a sweep as one ``while_loop`` on the device, this
is a host loop, as in :mod:`.arnoldi`.  The breakdown flag ``info`` stays a
0-d int32 tensor on the device; the loop reads it once per step, except
after the last, through :func:`..utils.timer.host_read`, which counts every
read.  Columns of ``U``, ``V`` and ``B`` are written in place, and each CGS2
reads only the filled columns.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import constants, vectors
from ..utils.timer import count_applications, host_read, time_lightkrylov, timed_fn
from .gram_schmidt import double_gram_schmidt_step

__all__ = ["bidiagonalization", "bidiag_step", "initialize_bidiag"]


def initialize_bidiag(u0, v_template, kdim: int):
    """Buffers: ``U`` with kdim+1 columns shaped like ``u0`` (the codomain),
    column 0 ``u0`` normalised; ``V`` with kdim zero columns shaped like
    ``v_template`` (the domain); a (kdim+1, kdim) zero ``B`` in ``u0``'s
    dtype."""
    U = vectors.zeros_basis(u0, kdim + 1)
    vectors.set_column(U, 0, vectors.scal(1.0 / vectors.norm(u0), u0))
    V = vectors.zeros_basis(v_template, kdim)
    B = torch.zeros((kdim + 1, kdim), dtype=vectors.dtype_of(u0),
                    device=pytree.tree_leaves(u0)[0].device)
    return U, V, B


def _unit(x, tol, ok_before=None):
    """``(x / |x|, |x|, ok)`` with ``ok = |x| > tol`` (and ``ok_before``);
    where not ok the column is zero."""
    nrm = vectors.norm(x)
    ok = nrm > tol if ok_before is None else ok_before & (nrm > tol)
    inv = torch.where(ok, 1.0 / torch.where(nrm == 0, torch.ones_like(nrm), nrm),
                      torch.zeros_like(nrm))
    return vectors.scal(inv, x), nrm, ok


def bidiag_step(A, U, V, B, k: int, tol: float = 0.0):
    """One Golub-Kahan step (0-based ``k``): ``v_k = A^H u_k`` against
    ``V[:k]``, then ``u_{k+1} = A v_k`` against ``U[:k+1]``, both by CGS2
    (reference: golub_kahan.fypp:26-61).  Writes column ``k`` of ``V``,
    column ``k+1`` of ``U`` and column ``k`` of ``B`` in place and returns
    ``(U, V, B, alpha, beta)``, the two norms as 0-d real tensors.

    ``B[:, k]`` holds the full CGS2 projection column of ``u``, not only
    ``alpha`` and ``beta``: in exact arithmetic it is ``alpha e_k``, but
    after a thick restart the factorization couples to the kept columns,
    and the full column keeps ``A V = U B`` exact (the JAX package's
    ``bidiag.py:58-71``)."""
    v = A.rmatvec(vectors.get_column(U, k))
    v, _ = double_gram_schmidt_step(v, vectors.lead(V, k))
    v, alpha, ok_a = _unit(v, tol)
    vectors.set_column(V, k, v)

    u = A.matvec(v)
    u, proj = double_gram_schmidt_step(u, vectors.lead(U, k + 1))
    u, beta, ok_b = _unit(u, tol, ok_a)
    vectors.set_column(U, k + 1, u)
    B[:, k] = 0
    B[: k + 1, k] = proj.to(B.dtype)  # B[k, k] = <u_k, A v_k>, alpha in exact arithmetic
    B[k + 1, k] = torch.where(ok_b, beta, torch.zeros_like(beta)).to(B.dtype)
    return U, V, B, alpha, beta


@timed_fn("krylov.bidiagonalization", "BaseKrylov")
def bidiagonalization(A, U, V, B, kstart: int = 1, kend: int | None = None,
                      tol: float | None = None):
    """Grow the factorization ``A V_k = U_{k+1} B_k`` from step ``kstart`` to
    ``kend`` (1-based, inclusive), in place.  Returns ``(U, V, B, info)``,
    ``info`` a 0-d int32 tensor on the device: ``k`` on a breakdown at step
    ``k`` (``alpha`` or ``beta`` at most ``tol``), ``-k`` on a NaN norm, else
    0 (reference: golub_kahan.fypp:7-61; qr.fypp:72-78).

    Each step applies one ``rmatvec`` and one ``matvec``; with timing on
    both are counted (the JAX package's ``bidiag.py:107-116``)."""
    kdim = B.shape[1]
    if kend is None:
        kend = kdim
    if tol is None:
        tol = constants.atol(B.dtype)
    info = torch.zeros((), dtype=torch.int32, device=B.device)
    k = kstart - 1
    while k < kend:
        U, V, B, alpha, beta = bidiag_step(A, U, V, B, k, tol=tol)
        info = torch.where((info == 0) & ((alpha <= tol) | (beta <= tol)), k + 1, info)
        info = torch.where(torch.isnan(alpha) | torch.isnan(beta), -(k + 1), info)
        info = info.to(torch.int32)
        k += 1
        if k < kend and int(host_read(info)) != 0:
            break
    if time_lightkrylov():
        i = int(host_read(info))
        steps = max(0, (abs(i) if i != 0 else kend) - kstart + 1)
        count_applications(A, steps, "matvec")
        count_applications(A, steps, "rmatvec")
    return U, V, B, info
