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
Schur and reorder replaced by ``schur_select``'s host LAPACK.

The device restarts of the JAX package's device projected path are here
too, with the Schur and filter steps on the card (:mod:`..utils.hessenberg`,
the Francis-QR kernel): :func:`iram_restart`, the exact-shift IRAM filter
for the default selector, and :func:`krylov_schur_device`, for any selector
and any input form (``p = 1`` and block ``p > 1``).  Both return the keep
count ``n`` as a 0-d tensor on the device: the next sweep starts at it
without a host read (a checkpoint reads it).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import vectors
from ..utils import linalg
from ..utils.hessenberg import francis_filter, ordschur_device, schur_real, take_at
from ..utils.timer import host_read, timed

__all__ = ["iram_restart", "krylov_schur", "krylov_schur_block", "krylov_schur_device",
           "median_selector"]


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


def _rows(X, idx):
    """The columns ``idx`` (a 1-d integer tensor) of a stacked basis."""
    return pytree.tree_map(lambda l: l.index_select(0, idx), X)


def _put_rows(X, idx, B):
    """Write the stacked block ``B`` into the columns ``idx`` of ``X``, in
    place."""
    pytree.tree_map(lambda Xl, Bl: Xl.index_copy_(0, idx, Bl), X, B)
    return X


def _at(M, i, j):
    """``M[i, j]`` for 0-d integer tensors, gathered on the device."""
    return take_at(M, i * M.shape[1] + j)


def iram_restart(X, H, n_target):
    """Restart through the exact-shift IRAM filter
    (:func:`..utils.hessenberg.francis_filter`), on the device: the
    replacement of :func:`krylov_schur`'s host ``schur``/``ordschur`` for the
    default keep-the-largest-by-modulus selection (the reference's median
    selector intent, IterativeSolvers.fypp:1099-1100).

    Filters ``H``, compresses the basis with the accumulated ``Z[:, :n+1]``
    (one ``linear_combination``) and forms the new residual by the IRAM
    update ``f = Hf[n, n-1] (X Z)[:, n] + beta Z[kdim-1, n-1] x_res``.  The
    result is a pure Arnoldi factorization: ``H'`` Hessenberg with the
    single coupling ``H'[n, n-1] = ||f||``, columns past ``n`` zero.

    The filter runs in float64 whatever ``H``'s dtype, and its ``Hf`` and
    ``Z`` return to that dtype: a float32 filter takes its shifts from
    eigenvalues in error by ``~kdim eps ||H||``, which on a clustered
    spectrum is the size of the gaps, and keeps another subspace than the
    exact shifts would.

    Returns ``(X', H', n, ok)``, ``n`` a 0-d int64 tensor (the next sweep
    starts at ``n + 1``), ``ok`` a 0-d bool tensor, False when the filter
    applied no sweep (the factorization is exact either way) (the JAX
    package's ``krylov_schur.py:59-118``)."""
    kdim = H.shape[1]
    dev, dt = H.device, H.dtype
    Hf, Z, n, ok = francis_filter(H[:kdim, :kdim].double(), n_target)
    Hf, Z = Hf.to(dt), Z.to(dt)
    idx = torch.arange(kdim, device=dev)
    beta = H[kdim, kdim - 1]
    nm1 = torch.clamp(n - 1, min=0)
    zero = torch.zeros((), dtype=dt, device=dev)
    Zc = torch.where(idx[None, :] <= n, Z, zero)
    Xc = vectors.linear_combination(vectors.lead(X, kdim), Zc)
    v_next = pytree.tree_map(lambda l: l[0], _rows(Xc, n.reshape(1)))
    x_res = vectors.get_column(X, kdim)
    c1 = _at(Hf, n, nm1)
    c2 = beta * _at(Z, torch.full_like(n, kdim - 1), nm1)
    f = pytree.tree_map(lambda a, b: c1 * a.to(dt) + c2 * b, v_next, x_res)
    bn = vectors.norm(f)
    inv = torch.where(bn > 0, 1.0 / torch.where(bn == 0, torch.ones_like(bn), bn),
                      torch.zeros_like(bn))
    v_new = vectors.scal(inv.to(dt), f)
    Xc = pytree.tree_map(
        lambda l: torch.where((idx < n).reshape((kdim,) + (1,) * (l.ndim - 1)), l,
                              torch.zeros((), dtype=l.dtype, device=l.device)), Xc)
    X_new = pytree.tree_map(lambda c, full: torch.cat([c, torch.zeros_like(full[:1])]), Xc, X)
    _put_rows(X_new, n.reshape(1), pytree.tree_map(lambda l: l.unsqueeze(0), v_new))
    mask = (idx[:, None] < n) & (idx[None, :] < n)
    H_new = torch.zeros_like(H)
    H_new[:kdim, :kdim] = torch.where(mask, Hf, zero)
    H_new.index_put_((n.reshape(1), nm1.reshape(1)), bn.to(dt).reshape(1))
    return X_new, H_new, n, ok


def krylov_schur_device(X, H, sel_wr, sel_wi, sel_mask, p: int = 1, k_eff=None):
    """Krylov-Schur restart for ANY selection on the device: the counterpart
    of :func:`krylov_schur` (reference: BaseKrylov.fypp:714-837) with the
    host ``schur``/``ordschur`` replaced by
    :func:`..utils.hessenberg.schur_real` (the Francis-QR kernel with its
    transform) and :func:`..utils.hessenberg.ordschur_device`.  Any input
    form (Hessenberg or the post-restart arrow form) is reduced first.

    The selector is host code, so the selection arrives by value:
    ``sel_wr``/``sel_wi`` are eigenvalues in any order (the check's
    modulus-descending list) and ``sel_mask`` the selector's verdict on each;
    each diagonal position of the device Schur form takes the flag of its
    nearest entry by value.  As in the JAX package (ROADMAP F3), the
    candidates include a zero-filled tail of ``sel_wr``/``sel_wi`` whose
    flags are False, so an active eigenvalue nearer to 0 than to its own
    entry is deselected.

    Returns ``(X', H', n, ok)``: ``H'`` the reordered quasi-triangular
    leading block with the coupling row ``beta Z[kdim-1, :n]`` at row ``n``
    (the arrow form), columns past ``n`` zero, the residual vector in
    column ``n``; ``n`` a 0-d int64 tensor; ``ok`` False when a block swap
    was rejected (the factorization is still exact, but of a partially
    reordered subspace: the caller routes the next restart elsewhere).

    ``p > 1`` restarts a block factorization (``kdim + p`` columns, ``H``
    of ``(kdim + p, kdim)``): the coupling block ``B = H[k:k+p, k-p:k]`` at
    the active size ``k = k_eff`` (a 0-d tensor, default ``kdim``), the
    spike ``B Zs[k-p:k, :n]`` in rows ``n .. n+p-1``, the ``p`` residual
    columns moved to ``n .. n+p-1``, and ``n`` exactly the selected count
    clamped to ``[1, min(k - 1, kdim - p)]`` without splitting a 2x2 block
    (the JAX package's ``krylov_schur.py:121-229``)."""
    kdim = H.shape[1]
    dev, dt = H.device, H.dtype
    idx = torch.arange(kdim, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    if p == 1 or k_eff is None:
        ke = torch.full((), kdim, dtype=torch.long, device=dev)
    else:
        ke = torch.as_tensor(k_eff, device=dev).long().reshape(())
    T, Zs, wr, wi, ok1 = schur_real(H[:kdim, :kdim], k_eff=None if p == 1 else ke)
    sel_wr = torch.as_tensor(sel_wr, device=dev).to(dt)
    sel_wi = torch.as_tensor(sel_wi, device=dev).to(dt)
    d = (wr[:, None] - sel_wr[None, :]) ** 2 + (wi[:, None] - sel_wi[None, :]) ** 2
    sel = torch.as_tensor(sel_mask, device=dev).to(torch.bool)[torch.argmin(d, dim=1)]
    if p > 1:
        sel = sel & (idx < ke)  # inactive (embedded identity) positions
    with timed("krylov_schur.ordschur_device", "BaseKrylov", device=True):
        T, Zs, sel, ok2 = ordschur_device(T, Zs, sel)
    n = torch.sum(sel).long()
    one, two = torch.ones_like(n), torch.full_like(n, 2)
    n = torch.where(n < 1, torch.where(T[1, 0] != 0, two, one), n)
    if p == 1:
        top = torch.full_like(n, kdim - 1)
        n = torch.where(n > top, torch.where(T[kdim - 1, kdim - 2] != 0, top - 1, top), n)
    else:
        top = torch.clamp(ke - 1, max=kdim - p)
        n = torch.where(n > top, torch.where(_at(T, top, top - 1) != 0, top - 1, top), n)
    mask2 = (idx[:, None] < n) & (idx[None, :] < n)
    H_new = torch.zeros_like(H)
    H_new[:kdim, :kdim] = torch.where(mask2, T, zero)
    if p == 1:
        spike = torch.where(idx < n, H[kdim, kdim - 1] * Zs[kdim - 1, :], zero)
        H_new.index_copy_(0, n.reshape(1), spike.reshape(1, -1))
    else:
        blk = torch.arange(p, device=dev)
        B = H.index_select(0, ke + blk).index_select(1, ke - p + blk)
        Zl = Zs.index_select(0, ke - p + blk)
        spike = torch.where(idx[None, :] < n, B @ Zl, zero)
        H_new.index_copy_(0, n + blk, spike.to(dt))
    Zc = torch.where(idx[None, :] < n, Zs, zero)
    Xc = vectors.linear_combination(vectors.lead(X, kdim), Zc)
    X_new = pytree.tree_map(lambda c, full: torch.cat([c, torch.zeros_like(full[:p])]), Xc, X)
    if p == 1:
        _put_rows(X_new, n.reshape(1), pytree.tree_map(lambda l: l[kdim:kdim + 1], X))
    else:
        blk = torch.arange(p, device=dev)
        _put_rows(X_new, n + blk, _rows(X, ke + blk))
    return X_new, H_new, n, ok1 & ok2
