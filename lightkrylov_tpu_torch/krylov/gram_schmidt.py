"""Classical Gram-Schmidt with re-orthogonalization (CGS2).

Counterpart of :mod:`lightkrylov_tpu.krylov.gram_schmidt` (reference:
src/Krylov/gram_schmidt.fypp): one CGS pass is
``proj = innerprod(X, y); y -= X proj`` (gram_schmidt.fypp:141-146,187-192),
and ``double_gram_schmidt_step`` runs two passes with the coefficients summed
(gram_schmidt.fypp:38-49,85-97).  Each pass is one matrix product over the
basis.

Callers may pass a view of the filled columns (``V[:k]``) or a whole buffer
whose unfilled columns are zero; the two give the same result.  The JAX
package's chunked active-prefix reads are not needed for that here.
"""

from __future__ import annotations

import torch

from .. import constants, vectors
from ..utils.logger import log_information, stop_error
from ..utils.timer import host_read

__all__ = ["orthogonalize_against_basis", "double_gram_schmidt_step"]


def _check_orthonormal_input(X) -> None:
    """Orthonormality check of the basis buffer (reference:
    ``if_chk_orthonormal``, gram_schmidt.fypp:26-34: logs when orthonormal,
    ``stop_error`` otherwise), as the JAX package's
    ``gram_schmidt.py:52-80``: the defect ``||X^H X - diag(live)||_F``
    against the float32 ``rtol``, ``live`` flagging the columns of norm
    above 1/2, so unfilled zero columns are allowed.  The defect is read to
    the host (one counted read)."""
    G = vectors.gram(X)
    live = torch.diagonal(G).real > 0.5
    defect = float(host_read(torch.linalg.norm(G - torch.diag(live.to(G.dtype)))))
    if defect < constants.rtol(torch.float32):
        log_information("Input basis orthonormal. Remove this check unless necessary "
                        "for better performance", "krylov", "double_gram_schmidt_step")
    else:
        stop_error(f"Input basis not orthonormal (defect {defect:.3e}).",
                   "krylov", "double_gram_schmidt_step")


def orthogonalize_against_basis(y, X):
    """One CGS pass: project ``y`` (a vector or a stacked block) against
    the basis ``X`` and subtract.  Returns ``(y_orth, proj)`` with
    ``proj = X^H y`` of shape (m,) for a vector, (m, p) for a block."""
    proj = vectors.innerprod(X, y)
    return vectors.axpby(1.0, y, -1.0, vectors.linear_combination(X, proj)), proj


def double_gram_schmidt_step(y, X, return_info: bool = False,
                             check_orthonormal: bool = False):
    """CGS2: two projection passes, coefficients summed
    (reference: ``double_gram_schmidt_step``, gram_schmidt.fypp:38-49,85-97).

    Returns ``(y_orth, proj)``; with ``return_info=True`` also a 0-d int32
    tensor on the device: the 1-based index of a column that vanished after
    both passes (norm below the dtype's atol), 0 when none did.  As in the
    JAX package this checks the post-CGS2 norm, not the input's, and for a
    block reports the *first* vanished column (gram_schmidt.py:114-168).

    ``check_orthonormal``: check first that ``X`` is orthonormal (zero
    columns allowed) and ``stop_error`` if it is not, the reference's
    ``if_chk_orthonormal`` (gram_schmidt.fypp:26-34); off by default, as in
    the JAX package.  The port runs eagerly, so the check works wherever it
    is asked for; the JAX package refuses it under ``jit``.
    """
    if check_orthonormal:
        _check_orthonormal_input(X)
    y1, p1 = orthogonalize_against_basis(y, X)
    y2, p2 = orthogonalize_against_basis(y1, X)
    if not return_info:
        return y2, p1 + p2
    tol = constants.atol(vectors.dtype_of(y2))
    if p1.ndim == 1:
        info = (vectors.norm(y2) < tol).to(torch.int32)
    else:
        small = torch.sqrt(torch.diagonal(vectors.gram(y2)).real) < tol
        first = torch.argmax(small.to(torch.int32)).to(torch.int32)
        info = torch.where(small.any(), first + 1, torch.zeros_like(first))
    return y2, p1 + p2, info
