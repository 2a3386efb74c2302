"""Krylov-Schur restart: compress an Arnoldi factorization onto a selected
invariant-subspace approximation.

Counterpart of the host ``krylov_schur`` of
:mod:`lightkrylov_tpu.krylov.krylov_schur` (reference:
src/Krylov/BaseKrylov.fypp:714-837): the Hessenberg is read to the host,
Schur-decomposed and reordered so that the eigenvalues a *global* selector
keeps lead (``schur_select``: ``schur`` + TRSEN, 2x2 blocks moved whole);
the new extended Hessenberg, ``T[:n, :n]`` with the coupling row
``b = H[kdim, kdim-1] * Z[kdim-1, :n]`` at row ``n``, is assembled on the
host; the basis is compressed on the device by one ``linear_combination``
``X' = X Z[:, :n]`` (BaseKrylov.fypp:821) and the residual vector moves to
column ``n``.  Arnoldi then continues from ``kstart = n + 1``.

:func:`krylov_schur_block` restarts a BLOCK Arnoldi factorization on the
host in the same way: it is the block branch of the JAX package's
``krylov_schur_device`` (its ``krylov_schur.py:168-229``) with the device
Schur and reorder replaced by ``schur_select``'s host LAPACK.  The JAX
package's device restarts themselves (``iram_restart``,
``krylov_schur_device``) are ROADMAP M10 and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import vectors
from ..utils import linalg
from ..utils.timer import host_read, timed

__all__ = ["krylov_schur", "krylov_schur_block", "median_selector"]


def median_selector(eigvals):
    """Default restart selector: keep the eigenvalues whose modulus is
    above the median (reference: the median-of-|lambda| selector of eigs,
    IterativeSolvers.fypp:1099-1100,1137-1142)."""
    mods = np.abs(eigvals)
    return mods > np.median(mods)


def krylov_schur(X, H, select=None):
    """Compress the factorization ``(X, H)`` (kdim filled columns plus the
    residual column) onto the ``n`` selected Ritz directions.

    Returns new ``(X, H, n)`` with the same buffer shapes: columns ``> n``
    zero and the residual vector in column ``n``, ready for Arnoldi from
    ``kstart = n + 1`` (reference: BaseKrylov.fypp:714-837).  ``n`` is
    clamped to ``[1, kdim - 1]`` as in the JAX host restart
    (``krylov_schur.py:246-247``), which does not check whether the clamp
    splits a 2x2 block of the real Schur form (ROADMAP F8)."""
    if select is None:
        select = median_selector
    kdim = H.shape[1]
    Hh = host_read(H)
    with timed("krylov_schur.schur_select", "BaseKrylov"):
        Tn, Zn, n = linalg.schur_select(Hh[:kdim, :kdim], select)
    n = max(1, min(n, kdim - 1))
    H_new = np.zeros(H.shape, dtype=Tn.dtype)
    H_new[:n, :n] = Tn[:n, :n]
    H_new[n, :n] = Hh[kdim, kdim - 1] * Zn[kdim - 1, :n]

    Zm = np.zeros_like(Zn)
    Zm[:, :n] = Zn[:, :n]
    Xc = vectors.linear_combination(vectors.lead(X, kdim),
                                    torch.from_numpy(Zm).to(H.device))
    X_new = pytree.tree_map(lambda c, full: torch.cat([c, torch.zeros_like(full[:1])]), Xc, X)
    vectors.set_column(X_new, n, vectors.get_column(X, kdim))
    return X_new, torch.from_numpy(H_new).to(H.device), n


def _keep_count(T, n: int, hi: int) -> int:
    """The selected count ``n`` clamped to ``[1, hi]`` without splitting a
    2x2 block of the real Schur form ``T``: the device rule of the JAX
    package (``krylov_schur.py:195-200``), not the host clamp of
    :func:`krylov_schur` (ROADMAP F8)."""
    if n < 1:
        n = 2 if T[1, 0] != 0 else 1
    if n > hi:
        n = hi - 1 if T[hi, hi - 1] != 0 else hi
    return n


def krylov_schur_block(X, H, select, p: int, k_eff: int):
    """Restart a block Arnoldi factorization: ``X`` holds ``kdim + p``
    columns, ``H`` is ``(kdim + p, kdim)`` and the active square is
    ``H[:k_eff, :k_eff]`` with the coupling block
    ``B = H[k_eff:k_eff+p, k_eff-p:k_eff]`` and the ``p`` residual columns
    ``X[k_eff:k_eff+p]``.

    The active square is Schur-decomposed and reordered so that what
    ``select`` keeps leads; ``n`` is EXACTLY the selected count (a conjugate
    pair counts whole), clamped to ``[1, min(k_eff - 1, kdim - p)]`` so that
    one block step fits after it, without splitting a 2x2 block.  The new
    ``H`` holds ``T[:n, :n]`` and the spike ``B @ Z[k_eff-p:k_eff, :n]`` in
    rows ``n .. n+p-1``; the basis is compressed by one
    ``linear_combination`` and the residual columns move to ``n .. n+p-1``;
    every other column is zero (the buffer invariant).  The block sweep
    continues at column offset ``n``.

    Returns ``(X', H', n, ok)`` (reference: the block branch of the JAX
    ``krylov_schur_device``, ``krylov_schur.py:168-229``).  ``ok`` is the
    host counterpart of its flag: False when the reorder was rejected, that
    is when an eigenvalue of the kept block is not one of the selected
    ones; the caller then restarts explicitly.  ``X`` and ``H`` are not
    modified."""
    kdim = H.shape[1]
    Hh = host_read(H)
    with timed("krylov_schur.schur_select", "BaseKrylov"):
        Ha = Hh[:k_eff, :k_eff]
        T, Z = linalg.schur(Ha)
        mask, w = linalg.selection_mask(T, select)
        Ts, Zs = linalg.ordschur(T, Z, mask)
        n_sel = int(mask.sum())
        n = _keep_count(Ts, n_sel, min(k_eff - 1, kdim - p))
        m = min(n, n_sel)
        kept = np.linalg.eigvals(Ts[:m, :m]) if m else np.zeros(0)
        scale = max(1.0, float(np.abs(w).max()))
        tol = np.sqrt(np.finfo(Ts.dtype).eps) * scale
        ok = bool(np.all(np.abs(kept[:, None] - w[mask][None, :]).min(axis=1) <= tol)) \
            if m else True
        H_new = np.zeros(H.shape, dtype=Ts.dtype)
        H_new[:n, :n] = Ts[:n, :n]
        B = Hh[k_eff:k_eff + p, k_eff - p:k_eff]
        H_new[n:n + p, :n] = B @ Zs[k_eff - p:k_eff, :n]

    dev = H.device
    Xc = vectors.linear_combination(vectors.lead(X, k_eff),
                                    torch.from_numpy(np.ascontiguousarray(Zs[:, :n])).to(dev))
    X_new = vectors.zero_basis_like(X)
    vectors.set_columns_block(X_new, 0, Xc)
    vectors.set_columns_block(X_new, n, pytree.tree_map(lambda l: l[k_eff:k_eff + p], X))
    return X_new, torch.from_numpy(H_new).to(dev), n, ok
