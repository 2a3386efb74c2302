"""Krylov basis utilities.

Counterpart of :mod:`lightkrylov_tpu.krylov.utilities` (reference:
src/Krylov/utilities.fypp): column permutation ``permcols`` and its inverse
``invperm`` (utilities.fypp:12-27), ``initialize_krylov_subspace`` (zero
buffer, seed block orthonormalized into the leading columns, :34-48),
``initialize_random_orthonormal_basis`` (:56-64), ``orthonormalize_basis``
as a QR wrapper (:72-82) and the orthonormality check
``||X^H X - I||_F < rtol`` (:90-98).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import constants, vectors
from .qr import cholesky_qr2, qr

__all__ = [
    "permcols",
    "invperm",
    "initialize_krylov_subspace",
    "initialize_random_orthonormal_basis",
    "orthonormalize_basis",
    "is_orthonormal",
]


def permcols(X, perm):
    """Permute stacked columns: ``Y_i = X_{perm[i]}`` (reference:
    utilities.fypp:12-27).  A 2-D tensor is taken as a coefficient matrix
    and its columns are permuted."""
    perm = torch.as_tensor(perm)
    if isinstance(X, torch.Tensor) and X.ndim == 2:
        return X[:, perm.to(X.device)]
    return pytree.tree_map(lambda l: l[perm.to(l.device)], X)


def invperm(perm):
    """Inverse permutation (reference: utilities.fypp:12-27)."""
    return torch.argsort(torch.as_tensor(perm))


def initialize_krylov_subspace(X, seed=None):
    """A zero buffer shaped like ``X`` whose leading column(s) hold the
    orthonormalized ``seed`` (reference: utilities.fypp:34-48).  ``seed``
    is a vector or a stacked block; returns the new buffer."""
    X = vectors.zero_basis_like(X)
    if seed is None:
        return X
    if pytree.tree_leaves(seed)[0].ndim == pytree.tree_leaves(X)[0].ndim - 1:
        return vectors.set_column(X, 0, vectors.scal(1.0 / vectors.norm(seed), seed))
    Q, _, _ = qr(seed)
    return vectors.set_columns_block(X, 0, Q)


def initialize_random_orthonormal_basis(generator, x_template, k: int):
    """Random orthonormal k-column basis drawn from ``generator``
    (reference: utilities.fypp:56-64).  A Gaussian basis is well
    conditioned with overwhelming probability, so CholeskyQR2 applies; the
    CGS2 fallback of :func:`orthonormalize_basis` covers the rest."""
    X = vectors.rand_basis(generator, vectors.zeros_basis(x_template, k))
    return orthonormalize_basis(X, generator=generator, method="cholqr2")


def orthonormalize_basis(X, generator=None, method: str = "cgs2"):
    """QR wrapper returning only Q (reference: utilities.fypp:72-82).
    ``method="cholqr2"`` tries :func:`.qr.cholesky_qr2` first and falls
    back to CGS2 :func:`.qr.qr` when the basis is numerically
    rank-deficient."""
    if method == "cholqr2":
        Q, _, info = cholesky_qr2(X)
        if info == 0:
            return Q
    Q, _, _ = qr(X, generator=generator)
    return Q


def is_orthonormal(X, rtol: float | None = None) -> torch.Tensor:
    """``||X^H X - I||_F < rtol`` as a 0-d bool tensor (reference:
    utilities.fypp:90-98, whose threshold is ``rtol_sp``)."""
    if rtol is None:
        rtol = constants.rtol(torch.float32)
    G = vectors.gram(X)
    return torch.linalg.norm(G - torch.eye(G.shape[0], dtype=G.dtype, device=G.device)) < rtol
