"""Small dense linear algebra of the GMRES least-squares problem.

Counterpart of ``givens_rotation``, ``apply_givens_rotation`` and
``solve_triangular`` in :mod:`lightkrylov_tpu.utils.linalg` (reference:
Utils.fypp:128-268; gmres.fypp:177-182,200).  Everything stays on the
tensors' device; nothing here reads a value back to the host.
"""

from __future__ import annotations

import torch

__all__ = ["givens_rotation", "apply_givens_rotation", "solve_triangular"]


def givens_rotation(a, b):
    """``(c, s)`` zeroing ``b`` against ``a``: complex-safe, ``c`` real,
    ``s`` of the inputs' dtype (reference: Utils.fypp:128-268)."""
    anorm = torch.abs(a)
    bnorm = torch.abs(b)
    d = torch.sqrt(anorm**2 + bnorm**2)
    d = torch.where(d == 0, torch.ones_like(d), d)
    c = anorm / d
    # phase-correct sine for complex entries; b/d for real
    phase = torch.where(anorm == 0, torch.ones_like(a),
                        a / torch.where(anorm == 0, torch.ones_like(anorm), anorm))
    s = phase.conj() * b / d
    both_zero = (anorm == 0) & (bnorm == 0)
    c = torch.where(both_zero, torch.ones_like(c), c)
    s = torch.where(both_zero, torch.zeros_like(s), s)
    return c, s


def apply_givens_rotation(h, c, s, k: int):
    """Apply the ``k`` stored rotations to column ``h`` (length >= k+2),
    compute the rotation annihilating ``h[k+1]``, and return the updated
    ``(h, c, s)`` (reference: Utils.fypp:128-268).

    ``k`` is a host integer, so the loop runs over the ``k`` rotations that
    exist; the JAX version loops over all ``len(c)`` of them with masking,
    which gives the same result.  Each rotation is applied as one 2x2
    product, to keep the number of small launches per rotation at two.
    ``h``, ``c`` and ``s`` are not modified.
    """
    h, c, s = h.clone(), c.clone(), s.clone()
    if k:
        ch = c[:k].to(h.dtype)
        G = torch.stack([torch.stack([ch, s[:k].conj()], -1),
                         torch.stack([-s[:k], ch], -1)], -2)      # (k, 2, 2)
        for i in range(k):
            h[i:i + 2] = G[i] @ h[i:i + 2]
    ck, sk = givens_rotation(h[k], h[k + 1])
    h[k] = ck * h[k] + sk.conj() * h[k + 1]
    h[k + 1] = 0
    c[k] = ck
    s[k] = sk
    return h, c, s


def solve_triangular(R, b, lower: bool = False):
    """Triangular solve ``R y = b`` for a 1-D or 2-D ``b``
    (reference: ``trtrs`` call, gmres.fypp:200)."""
    if b.ndim == 1:
        return torch.linalg.solve_triangular(R, b[:, None], upper=not lower)[:, 0]
    return torch.linalg.solve_triangular(R, b, upper=not lower)
