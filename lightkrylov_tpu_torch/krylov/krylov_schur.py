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

The JAX package's device restarts (``iram_restart``,
``krylov_schur_device``) are ROADMAP M10 and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import vectors
from ..utils import linalg
from ..utils.timer import host_read, timed

__all__ = ["krylov_schur", "median_selector"]


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
